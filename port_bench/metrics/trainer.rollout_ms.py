"""Mean host-clock time of the trainer's rollout phase (nsteps of policy and
env step, or the replay of their graph) per window iteration, each span
ended by the device's sync."""
import statistics

WRAPS = ("trainer", "rollout_phase", "trainer.rollout")


def read(r):
    t = r.spans.get("trainer.rollout")
    return 1e3 * statistics.fmean(t) if t else None
