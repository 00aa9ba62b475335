"""The readings that a cell's limits are set from, on the card at the cell's
own size (not run by the benchmark's runs):

  program  the port's checked iterations against the reference, per seed
           (the lower readings);
  reorder  a sound program that rounds otherwise (reference/ppo.py), in the
           port's place, against the reference (lower readings too);
  control  the reference in the next precision down, put in the port's
           place, against the reference (the upper readings);
  <fault>  the reference with a planted fault (reference/ppo.py FAULTS) in
           the port's place, against the reference.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 3 ... \\
        --control-seeds 1 2 3 [--iterations N] [--out port_bench/out/calibrate.jsonl]

One JSON line per reading goes to standard output and to --out.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def readings(name: str, seeds, control_seeds, device="cuda", cell=None, config=None,
             iterations=None, witness=True):
    """Yield one dict per reading: {"seed", "side", numbers...}."""
    import torch

    from port_bench import harness
    from port_bench.reference import compare
    from port_bench.reference.ppo import FAULTS

    if cell is None:
        cell, config = harness.load_cell(name)
    mod = harness.trainer_module(config)
    dev = torch.device(device)
    n = iterations or cell["checked_iterations"]
    for seed in seeds:
        t0 = time.perf_counter()
        built = mod.build(config, cell, seed, dev)
        prog = mod.checked(built, config, n)
        del built
        gc.collect()
        ref = mod.reference(config, cell, seed, dev, n)
        yield {"seed": seed, "side": "program", **compare.numbers(prog, ref),
               "seconds": time.perf_counter() - t0, "detail": compare.detail(prog, ref)}
        sides = (["reorder"] if witness else []) + \
            (["control", *FAULTS] if seed in control_seeds else [])
        for side in sides:
            t0 = time.perf_counter()
            other = mod.reference(config, cell, seed, dev, n,
                                  precision=side if side in ("control", "reorder") else "stated",
                                  fault=side if side in FAULTS else None)
            yield {"seed": seed, "side": side, **compare.numbers(other, ref),
                   "seconds": time.perf_counter() - t0, "detail": compare.detail(other, ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--iterations", type=int, default=None,
                   help="iterations to read (default: the cell's checked iterations)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    fh = open(args.out, "a") if args.out else None
    try:
        for row in readings(args.workload, args.seeds, set(args.control_seeds),
                            iterations=args.iterations):
            line = json.dumps(row)
            print(line, flush=True)
            if fh:
                fh.write(line + "\n")
                fh.flush()
    finally:
        if fh:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
