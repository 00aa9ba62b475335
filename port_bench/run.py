"""The benchmark's command: one run of one cell on the card.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`, then
`window` and, last, `checks`: each number compared beside its limit), and
the same numbers as the last lines of standard error.  Exits non-zero and
prints no result without a CUDA card (or with fewer than the cell asks
for), and when a module of the JAX stack or the JAX package is loaded once
the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one host thread for the math libraries: the port's host work is launching
# kernels, and a one-card machine shares its host's cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from port_bench import harness

    torch.set_num_threads(1)

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.banned_modules()
    if found:
        print(f"modules of the JAX stack loaded in this process: {found}", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
