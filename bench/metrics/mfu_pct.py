"""``mfu_pct``: the whole round's share of the cards' float32 peak.  The
model operations of every local-SGD sample trained in the traced window
(forward and backward, 3 × the configuration's forward count; all K
clients a round in continuous mode, the real transmitters in participants
mode), over the window's time, over 67 TFLOP/s a card."""
from fedbench import peaks


def samples(ctx) -> int:
    cfg, tr = ctx["config"], ctx["traffic"]
    per = int(cfg["local_iters"]) * int(cfg["batch_size"])
    if tr["local_mode"] == "continuous":
        return ctx["rounds"] * int(tr["clients"]) * per
    return sum(int(n.sum()) for n in (r["n_tx"] for r in ctx["runs"])) * per


def read(ctx):
    if not ctx["rounds"] or not ctx.get("trace"):
        return None
    flops = 3 * ctx["model"].forward_flops(ctx["config"]) * samples(ctx)
    return 100.0 * flops / ctx["window_s"] / (
        peaks.FP32_FLOPS * len(ctx["devices"]))
