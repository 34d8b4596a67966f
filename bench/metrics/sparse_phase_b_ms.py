"""``sparse_phase_b_ms``: the sparse engine's phase B (through its
readback) a round on the card: the device time of the program's span
``sparse.phase_b`` (``sparse.phase_b.device``, timed by CUDA events
while the profiler records; the longest of the cards' when placed), its
total over the traced window, over the rounds completed there."""


def read(ctx):
    s = ctx["spans"].get("sparse.phase_b.device")
    if not s or not ctx["rounds"]:
        return None
    return 1e3 * s / ctx["rounds"]
