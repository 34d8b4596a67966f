"""Batched serving example on the PyTorch port: prefill + greedy decode on
a reduced assigned architecture, through ``repro_torch.launch.serve`` (the
deprecated alias of ``repro_torch.launch.generate``), as
``examples/serve_batched.py`` runs ``repro.launch.serve``.

    PYTHONPATH=src python examples/serve_batched_torch.py         # the card
    PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""
import argparse
import subprocess
import sys


def command(argv=None) -> list[str]:
    """The ``repro_torch.launch.serve`` command line the example runs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           args.arch, "--reduced", "--batch", str(args.batch),
           "--new-tokens", str(args.new_tokens)]
    return cmd + (["--device", args.device] if args.device else [])


if __name__ == "__main__":
    sys.exit(subprocess.call(command()))
