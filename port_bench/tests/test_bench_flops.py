"""Counted work against hand-worked values."""
from port_bench import harness
from port_bench.roofline import b1, mlp
from port_bench.trainers import ppo


def test_tenant_ppo_forward_is_7963648_flop_a_sample():
    actor = mlp.flops(388, (1024, 1024, 512), 80)
    critic = mlp.flops(388, (1024, 1024, 512), 1)
    assert actor["fwd_hidden"] + actor["fwd_head"] == 2 * 2_011_136
    assert critic["fwd_hidden"] + critic["fwd_head"] == 2 * 1_970_688
    assert sum(actor[k] + critic[k] for k in ("fwd_hidden", "fwd_head")) == 7_963_648


def test_tenant_ppo_iteration_work():
    cell, config = harness.load_cell("tenant-ppo.e4096")
    w = ppo.counted_work(config, cell)
    T, E, S = 8, 4096, 5 * 8 * 4096
    hid = 388 * 1024 + 1024 * 1024 + 1024 * 512      # hidden MACs of one net
    later = 1024 * 1024 + 1024 * 512                 # MACs of the layers after the first
    # forward 2 x MACs; backward: weight gradients 2 x MACs, input gradients
    # 2 x MACs of every layer but the first
    per_net = 2 * hid * (T * E) + S * (2 * hid + 2 * hid + 2 * later)
    assert w["bf16_flop"] == 2 * per_net + 2 * hid * E          # + the last value's critic pass
    heads = 512 * 80 + 512 * 1
    assert w["fp32_flop"] == 2 * heads * T * E + 2 * 512 * E + S * 6 * heads
    assert w["b1_launches"] == 24
    assert w["b1_ops"] == 24 * b1.OPS_PER_ARTICULATION * 40960


def test_tenant_mappo_layer_flops():
    """cfg/mappo's TenAnt actor (obs 38 -> 512 -> 512 -> 8, per agent): the
    counter at those shapes, for the MAPPO cell a later benchmark PR adds."""
    actor = mlp.flops(38, (512, 512), 8)
    assert actor["fwd_hidden"] == 2 * (38 * 512 + 512 * 512) == 563_200
    assert actor["bwd_hidden"] == 2 * (38 * 512 + 512 * 512) + 2 * 512 * 512 == 1_087_488
    assert actor["fwd_head"] == 2 * 512 * 8


def test_b1_bound_at_the_cell_size():
    bound, by = b1.bound_s(40960, 4096)
    assert by == "operations"
    assert abs(bound * 1e3 - 0.0186) < 0.0001      # PERF.md's B1 bound, ms
