"""``k1_roofline_pct``: the aggregation kernel K1 (eq. 3) against the
card's memory bandwidth.  The bytes are the benchmark's own count: each
launch's input rows read once (``rows × M`` elements, with the weights
of those rows), the global row read once and the output row written once.
Rows are all K of a plain launch, all K/d of a block's launch under
placement, and only the round's real transmitters of a participant
bucket (not its padding).  Their least time at 3.35 TB/s over the summed
device time of the K1 kernels in the trace."""
from fedbench import peaks

KERNEL = "fl_aggregate_tma"


def launch_bytes(rows: int, width: int, elem: int = 4) -> int:
    """Bytes one launch of ``rows`` rows of ``width`` elements needs."""
    return (rows * width + 2 * width) * elem + 4 * rows


def launches(ctx) -> list:
    """``(mode, rows)`` of every K1 launch of the traced runs."""
    tr = ctx["traffic"]
    out = []
    for run in ctx["runs"]:
        for n in run["n_tx"]:
            if tr["engine"] == "sparse":
                out.append(("subset", int(n)))
            elif ctx["blocks"] > 1:
                out += [("subset", int(tr["clients"]) // ctx["blocks"])] \
                    * ctx["blocks"]
            else:
                out.append(("plain", int(tr["clients"])))
    return out


def read(ctx):
    trace = ctx.get("trace") or {}
    seconds = sum(v for k, v in trace.get("kernels", {}).items()
                  if KERNEL in k)
    plan = launches(ctx)
    k1 = ctx["k1"]
    if (not seconds or len(plan) != k1["launches"] or k1["guarded"]
            or sum(m == "subset" for m, _ in plan) != k1["subset"]):
        return None
    need = sum(launch_bytes(r, ctx["width"]) for _, r in plan)
    return 100.0 * need / peaks.HBM_BYTES_PER_S / seconds
