"""The window's arithmetic: a rate over whole iterations, a percentile over
every iteration."""
import pytest

from port_bench import window


def test_rate_counts_whole_iterations_over_the_window():
    assert window.rate(8 * 4096, 120, 40.0) == pytest.approx(8 * 4096 * 3)


def test_p90_over_every_iteration_sees_a_stall():
    steady = [0.33] * 95 + [1.2] * 5           # a periodic stall in 5 of 100
    assert window.percentile(steady, 90) == 0.33
    stalls = [0.33] * 85 + [1.2] * 15          # 15 of 100 lie beyond the 90th percentile
    assert window.percentile(stalls, 90) == 1.2
    assert window.percentile([3.0, 1.0, 2.0], 100) == 3.0


def test_empty_or_zero_windows_raise():
    with pytest.raises(ValueError):
        window.percentile([], 90)
    with pytest.raises(ValueError):
        window.rate(1, 1, 0.0)
