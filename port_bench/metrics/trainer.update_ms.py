"""Mean host-clock time of the trainer's update phase (GAE and every
minibatch step, or the replay of their graph) per window iteration, each
span ended by the device's sync."""
import statistics

WRAPS = ("trainer", "update_phase", "trainer.update")


def read(r):
    t = r.spans.get("trainer.update")
    return 1e3 * statistics.fmean(t) if t else None
