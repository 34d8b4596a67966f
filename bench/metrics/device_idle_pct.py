"""``device_idle_pct``: the share of the traced window in which no
kernel, copy or set ran on a card, from the profiler's trace, averaged
over the cards the run uses."""


def read(ctx):
    trace = ctx.get("trace") or {}
    if not trace.get("window_s") or not any(trace["busy_s"].values()):
        return None
    w = trace["window_s"]
    idle = [1.0 - trace["busy_s"][d] / w for d in ctx["devices"]]
    return 100.0 * sum(idle) / len(idle)
