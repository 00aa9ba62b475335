"""The frozen B1 operation count against a fresh count of the frozen plain
substep."""
from port_bench.roofline import b1


def test_frozen_count_matches_a_fresh_count():
    per_art, table = b1.count_ops_per_articulation()
    assert per_art == b1.OPS_PER_ARTICULATION
    assert table == b1.TABLE_FLOATS
