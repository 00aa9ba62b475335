"""Small cells for the CPU tests: the tenant-ppo configuration at tiny
widths and eight envs, on the port's plain paths."""
import copy

import pytest

from port_bench import harness


def tiny(hidden=(32, 32), num_envs=8):
    cell, config = harness.load_cell("tenant-ppo.e4096")
    config = copy.deepcopy(config)
    config["train"].update(hidden=list(hidden), nsteps=2, noptepochs=2, nminibatches=2)
    return dict(cell, num_envs=num_envs, trace_iterations=1), config


@pytest.fixture
def tiny_cell():
    return tiny()
