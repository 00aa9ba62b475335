"""The trace reduction on made-up profiler events."""
import pytest

from port_bench import trace


class Ev:
    """torch's _KinetoEvent as far as trace.read reads it."""

    def __init__(self, act, name, a, b):
        self._dev = "DeviceType.CUDA" if act in ("kernel", "gpu_memcpy", "device copy") \
            else "DeviceType.CPU"
        self._name, self._a, self._b = name, a, b

    def device_type(self):
        return self._dev

    def name(self):
        return self._name

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    evs = [Ev("user_annotation", "port_bench.env.step", 0, 600),
           Ev("device copy", "port_bench.env.step", 0, 600),     # the annotation's device copy
           Ev("cpu_op", "aten::mul", 0, 100),
           Ev("cpu_op", "aten::add", 150, 400),
           Ev("kernel", "substep_kernel", 100, 300),
           Ev("kernel", "elementwise_kernel", 250, 350),      # overlaps the first
           Ev("gpu_memcpy", "Memcpy DtoH", 500, 550),
           Ev("kernel", "nvjet_gemm", 2000, 2100)]            # outside the window
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
