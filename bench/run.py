"""The benchmark of the PyTorch/CUDA port:

    python3 bench/run.py --workload <w> --seed <n> --seconds <s> --trace <0|1>

prints one JSON line, the last of its standard output (see
``bench/fedbench/harness.py``)."""
import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fedbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
