"""Start the processes of a data-parallel job on this host (the port's
counterpart of scripts/run_multiprocess.py / run_multiprocess.sh).

    python -m massive_marl_tpu_torch.parallel.launch --nproc 4 [--backend gloo] \
        -- --task TenAnt --algo mappo --num_envs 8 --max_iterations 2 --device cpu

Each of the N processes runs `python -m massive_marl_tpu_torch.cli.train
<args>` (launch() takes another module) with MMT_COORDINATOR=localhost:<a
free port>, MMT_NUM_PROCESSES=N and MMT_PROCESS_ID=i, the variables that
parallel/mesh.init_distributed reads, and MMT_BACKEND when --backend is
given (NCCL refuses two ranks on one card: two ranks sharing a card take
gloo).  OMP_NUM_THREADS defaults to 1 in each rank.  The launcher waits for
every rank, ends the others once one fails (a rank blocked in a collective
would wait for it forever), and exits with the first non-zero code.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

CLI = "massive_marl_tpu_torch.cli.train"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(nproc: int, args, backend: str | None = None, module: str = CLI,
           timeout: float | None = None, env: dict | None = None) -> int:
    """Run `python -m module *args` in nproc ranks; the first non-zero exit
    code of a rank (124 when `timeout` seconds pass), else 0."""
    base = dict(os.environ if env is None else env)
    base.setdefault("OMP_NUM_THREADS", "1")
    base.update(MMT_COORDINATOR=f"localhost:{free_port()}", MMT_NUM_PROCESSES=str(nproc))
    if backend:
        base["MMT_BACKEND"] = backend
    procs = [subprocess.Popen([sys.executable, "-m", module, *args],
                              env=dict(base, MMT_PROCESS_ID=str(i)))
             for i in range(nproc)]
    t_end = None if timeout is None else time.monotonic() + timeout
    rc = 0
    try:
        while [p.poll() for p in procs].count(None):
            failed = [p.returncode for p in procs if p.returncode not in (None, 0)]
            if failed or (t_end is not None and time.monotonic() > t_end):
                rc = failed[0] if failed else 124
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc or next((p.returncode for p in procs if p.returncode), 0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    rest = []
    if "--" in argv:
        i = argv.index("--")
        argv, rest = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, required=True, help="ranks to start")
    p.add_argument("--backend", default=None, help="nccl | gloo (default: by device)")
    p.add_argument("--timeout", type=float, default=None, help="seconds before the ranks end")
    a = p.parse_args(argv)
    return launch(a.nproc, rest, a.backend, timeout=a.timeout)


if __name__ == "__main__":
    sys.exit(main())
