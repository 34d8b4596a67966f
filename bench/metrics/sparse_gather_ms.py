"""``sparse_gather_ms``: the sparse engine's participant gather a round on
the card: the device time of the program's span ``sparse.gather``
(``sparse.gather.device``, timed by CUDA events while the profiler
records; the longest of the cards' when placed), its total over the
traced window, over the rounds completed there."""


def read(ctx):
    s = ctx["spans"].get("sparse.gather.device")
    if not s or not ctx["rounds"]:
        return None
    return 1e3 * s / ctx["rounds"]
