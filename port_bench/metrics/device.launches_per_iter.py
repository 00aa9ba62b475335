"""CUDA kernel launches per iteration in the profiled iterations."""


def read(r):
    if r.trace is None or r.trace.iterations == 0:
        return None
    return r.trace.launches / r.trace.iterations
