"""PyTorch's CPU threads for the benchmark's tests under pytest-xdist:
each of N workers gets ``cores // N`` threads (PyTorch would start one a
core in every worker, and small operations then slow down by orders of
magnitude); a single process keeps PyTorch's default."""
import os


def share_cores() -> None:
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch
        cores = (len(os.sched_getaffinity(0))
                 if hasattr(os, "sched_getaffinity") else os.cpu_count())
        torch.set_num_threads(max(1, (cores or 1) // int(workers)))
