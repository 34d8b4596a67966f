"""Readings for the limits of ``correct`` (bench/limits/<workload>.json),
at the cell's own size, several seeds in one process:

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 [--control]

For each seed it makes the cell's inputs, runs the program once through
the runner the window drives (one seed lane, all T rounds), frees it, runs
the plain reference on the same lane and prints the numbers compared.  With
``--control`` it also runs the control, the reference in the precision
below the configuration's (TF32 products, a bfloat16 energy ledger), and
prints its numbers against the reference.  One JSON object a seed."""
import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fedbench import compare, harness, program, reference, spec  # noqa: E402
from fedbench.world import make_world  # noqa: E402


def as_program(ref: dict, layers: list) -> dict:
    """A reference run's outputs in the program's format."""
    out = dict(ref)
    out["global"] = compare.encode(ref["global"], layers)
    if "clients" in ref:
        out["clients"] = compare.encode(ref["clients"], layers)
    return out


def readings(cell, seed: int, devices, control: bool) -> dict:
    """One seed's numbers: the program's run of lane 1 against the
    reference, and with ``control`` the control's."""
    import torch
    layers = cell.config["layers"]
    t = time.time()
    world = make_world(cell, seed, devices[0],
                       store_device="cpu" if len(devices) > 1 else None)
    runner = program.build_runner(cell, world, devices)
    clients = program.sample_clients(cell, seed)
    lane = world.lane(1)
    out = program.outputs(runner(world.params, world.h, seed=lane),
                          clients)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    t_prog = time.time() - t
    t = time.time()
    ref = reference.run(cell, world, lane, devices, clients=clients)
    row = {"seed": seed,
           "program": harness.check_numbers(cell, world, lane, devices, out,
                                            clients, ref=ref),
           "program_s": t_prog, "reference_s": time.time() - t}
    if control:
        ctl = as_program(reference.run(cell, world, lane, devices, "tf32",
                                       clients), layers)
        row["control"] = harness.check_numbers(cell, world, lane, devices,
                                               ctl, clients, ref=ref)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    cell = spec.cell(args.workload)
    harness._cache_dirs()
    sys.path.insert(0, str(spec.ROOT / "src"))
    import torch
    if torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} cards")
        return 2
    devices = [torch.device(f"cuda:{i}") for i in range(cell.chips)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, devices, args.control)),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
