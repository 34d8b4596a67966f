"""``sparse_train_ms``: the participant gather and the sparse engine's
phase B (through its readback) a round: the program's span
``sparse.train``, its total over the traced window, over the rounds
completed there."""


def read(ctx):
    s = ctx["spans"].get("sparse.train")
    if not s or not ctx["rounds"]:
        return None
    return 1e3 * s / ctx["rounds"]
