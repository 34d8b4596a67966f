"""The benchmark of the PyTorch/CUDA port (``repro_torch``): simulated
rounds a second of the paper's asynchronous FL, with a plain reference
that decides ``correct``.  ``bench/run.py`` is the entry point."""
