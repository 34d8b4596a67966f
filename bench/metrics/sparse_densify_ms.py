"""``sparse_densify_ms``: the sparse engine's end of a run on the host (the
participant trace's readbacks and the densification of its ``[T, K]``
arrays): the program's span ``sparse.densify`` on the host clock, its
total over the traced window, over the rounds completed there."""


def read(ctx):
    s = ctx["spans"].get("sparse.densify")
    if not s or not ctx["rounds"]:
        return None
    return 1e3 * s / ctx["rounds"]
