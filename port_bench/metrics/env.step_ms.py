"""Mean host-clock time of one env step_batch call in the window (the
physics substeps on B1, the box substep, resets, observations, rewards),
each span started and ended by the device's sync."""
import statistics


def read(r):
    t = r.spans.get("env.step")
    return 1e3 * statistics.fmean(t) if t else None
