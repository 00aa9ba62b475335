"""Mean host-clock time of one env step_batch call in the window (the
physics substeps on B1, the box substep, resets, observations, rewards),
each span started and ended by the device's sync.  The harness wraps the
env's step_batch for it in the cells that list it; PPO's rollout graph
refuses such an env, so no PPO cell lists it."""
import statistics

WRAPS = ("env", "step_batch", "env.step")


def read(r):
    t = r.spans.get("env.step")
    return 1e3 * statistics.fmean(t) if t else None
