"""The trace reduction on made-up profiler events."""
import pytest

from port_bench import trace

PREFIXES = ("port_bench.", "mmt.")


class Ev:
    """torch's _KinetoEvent as far as trace.read reads it: `act`, the
    profiler's activity type, sets the device; `corr` is the event's
    correlation id (a runtime call and the device operations it launched
    share one; a host op has its own), `link` the host op that a device
    operation is linked to."""

    def __init__(self, act, name, a, b, corr=0, link=0):
        self._dev = "DeviceType.CUDA" if act in ("kernel", "gpu_memcpy", "gpu_user_annotation") \
            else "DeviceType.CPU"
        self._name, self._a, self._b = name, a, b
        self._corr, self._link = corr, link

    def device_type(self):
        return self._dev

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._link


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    evs = [Ev("user_annotation", "port_bench.env.step", 0, 600),
           Ev("gpu_user_annotation", "port_bench.env.step", 0, 600),   # its device copy
           Ev("cpu_op", "aten::mul", 0, 100),
           Ev("cpu_op", "aten::add", 150, 400),
           Ev("kernel", "substep_kernel", 100, 300),
           Ev("kernel", "elementwise_kernel", 250, 350),      # overlaps the first
           Ev("gpu_memcpy", "Memcpy DtoH", 500, 550),
           Ev("kernel", "nvjet_gemm", 2000, 2100)]            # outside the window
    # one prefix as a plain string, as chip_smoke.py passes it
    t = trace.read(evs, 0, 1000, 2, "port_bench.")
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(300e-9)                  # 100-350 and 500-550
    assert t.launches == 2
    assert t.kernel_time("substep_kernel") == (1, pytest.approx(200e-9))
    # a gap is named by what the host was doing where it starts
    assert t.idle["env.step: aten::mul"] == pytest.approx(100e-9)              # 0-100
    assert t.idle["env.step: aten::add"] == pytest.approx(150e-9)              # 350-500
    assert t.idle["env.step: host outside any op"] == pytest.approx(450e-9)    # 550-1000
    b = t.breakdown()
    assert b["device_ops"][0] == ["B1 substep kernel", pytest.approx(200e-9)]
    assert len(b["idle_gaps"]) == 3
    text = t.summary()
    assert "substep_kernel" in text and "env.step: aten::add" in text


def _phases():
    """Two phases of one iteration: a rollout that replays a graph, whose
    kernels run after the rollout's host span has ended, and an eager update."""
    return [Ev("user_annotation", "port_bench.window", 0, 10_000),
            Ev("user_annotation", "mmt.trainer.rollout", 100, 1000),
            Ev("user_annotation", "mmt.rollout.graph", 200, 900),
            Ev("cuda_runtime", "cudaGraphLaunch", 300, 400, corr=7),
            Ev("kernel", "substep_kernel", 1500, 2500, corr=7),          # graph nodes
            Ev("kernel", "elementwise_kernel", 2600, 2700, corr=7),
            Ev("user_annotation", "mmt.trainer.update", 1000, 3000),
            Ev("cpu_op", "aten::mm", 1050, 1200, corr=7),     # torch's own ids: another space
            Ev("cuda_runtime", "cudaLaunchKernel", 1100, 1110, corr=8, link=7),
            Ev("kernel", "nvjet_gemm", 2800, 2900, corr=8, link=7),
            Ev("cpu_op", "aten::mul", 1300, 1400, corr=55),
            # a kernel whose launch the trace lacks, linked to its host op
            Ev("kernel", "elementwise_kernel", 3000, 3050, corr=9, link=55),
            Ev("kernel", "reduce_kernel", 3100, 3400, corr=10),       # linked to nothing
            Ev("cuda_runtime", "cudaMemcpyAsync", 3500, 3600, corr=11),
            Ev("gpu_memcpy", "Memcpy DtoH", 3600, 3700, corr=11)]     # in the window alone


def test_a_replayed_kernel_counts_in_the_span_around_its_graph_launch():
    t = trace.read(_phases(), 0, 10_000, 1, PREFIXES)
    # both graph nodes ran after trainer.rollout's host span had ended
    assert t.span_time("trainer.rollout") == (2, pytest.approx(1100e-9))
    assert t.span_time("rollout.graph") == (2, pytest.approx(1100e-9))
    assert t.self_spans["rollout.graph"] == (2, pytest.approx(1100e-9))
    assert "trainer.rollout" not in t.self_spans
    # the update's kernel by its runtime call, the other by its linked op
    assert t.span_time("trainer.update") == (2, pytest.approx(150e-9))
    # the copy was launched in the window, outside the trainer's spans
    assert t.self_spans["window"] == (0, pytest.approx(100e-9))
    assert t.span_time("window") == (4, pytest.approx(1350e-9))


def test_an_operation_linked_to_no_host_call_is_unattributed():
    t = trace.read(_phases(), 0, 10_000, 1, PREFIXES)
    assert t.unattributed_s == pytest.approx(300e-9)
    assert t.device_s == pytest.approx(1650e-9)
    assert sum(s for _, s in t.self_spans.values()) + t.unattributed_s == \
        pytest.approx(t.device_s)
    text = t.summary()
    assert "unattributed" in text and "18.18%" in text and "rollout.graph" in text


def test_gaps_are_named_by_the_innermost_span_of_either_prefix():
    evs = [Ev("user_annotation", "port_bench.trainer.rollout", 0, 1000),
           Ev("user_annotation", "mmt.trainer.rollout", 10, 990),
           Ev("user_annotation", "mmt.env.step", 100, 500),
           Ev("kernel", "substep_kernel", 0, 100),
           Ev("kernel", "substep_kernel", 600, 700)]
    t = trace.read(evs, 0, 1000, 1, PREFIXES)
    assert t.idle == {"env.step: host outside any op": pytest.approx(500e-9),
                      "trainer.rollout: host outside any op": pytest.approx(300e-9)}
    # the harness's span alone names a gap outside the program's
    t = trace.read(evs[:1] + evs[3:], 0, 1000, 1, PREFIXES)
    assert set(t.idle) == {"trainer.rollout: host outside any op"}
