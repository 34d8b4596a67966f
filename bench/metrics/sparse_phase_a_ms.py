"""``sparse_phase_a_ms``: the sparse engine's phase A (participation over
``[T, K]``, through its ``n_tx`` readback) a round: the program's span
``sparse.phase_a``, its total over the traced window, over the rounds
completed there."""


def read(ctx):
    s = ctx["spans"].get("sparse.phase_a")
    if not s or not ctx["rounds"]:
        return None
    return 1e3 * s / ctx["rounds"]
