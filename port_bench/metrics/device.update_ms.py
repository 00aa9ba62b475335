"""Device time per profiled iteration of the operations launched inside the
program's `trainer.update` span, at any depth: a CUDA graph's replayed
kernels count with the cudaGraphLaunch inside `update.graph` that runs
them.  Nothing to read without a trace or without such an operation."""


def read(r):
    if r.trace is None:
        return None
    _, s = r.trace.span_time("trainer.update")
    return 1e3 * s / r.trace.iterations if s > 0 else None
