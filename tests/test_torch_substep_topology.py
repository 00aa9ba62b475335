"""The ant's tree compiled into csrc/substep.cu against the tables the port
bakes, and the wrappers' refusal of a table baked from another tree.

The substep kernel indexes its per-body state with compile-time indices:
PARENT, POINT_START, CHAIN_MASK, BODY_OF_DOF and BODY_SENSOR are constexpr
arrays in the source (parsed here as test_torch_fused_substep.py parses
the table offsets), and fused_substep.KERNEL_TREE repeats them for the
wrappers' check.  CPU only: no card, no nvcc, no JAX; the wrappers' refusal
on the card is in test_torch_fused_substep.py.
"""
import dataclasses
import pathlib
import re
import types

import pytest
import torch

from massive_marl_tpu_torch.cli import debug_fused
from massive_marl_tpu_torch.envs.one_ant import OneAntEnv
from massive_marl_tpu_torch.envs.ten_ant import TenAntEnv
from massive_marl_tpu_torch.ops import fused_substep as fs
from massive_marl_tpu_torch.ops import scalar_phys as sp

SOURCE = pathlib.Path(fs.__file__).parent / "csrc" / "substep.cu"
CU_ARRAYS = {"PARENT": "parent", "POINT_START": "point_start", "CHAIN_MASK": "chain_mask",
             "BODY_OF_DOF": "body_of_dof", "BODY_SENSOR": "body_sensor"}


def _compiled_tree() -> dict:
    """{KERNEL_TREE key: tuple} from the source's `constexpr int NAME[..] =
    {...};` lines."""
    src = SOURCE.read_text()
    out = {}
    for name, body in re.findall(r"constexpr int (\w+)\[[^\]]*\] = \{([^}]*)\};", src):
        if name in CU_ARRAYS:
            out[CU_ARRAYS[name]] = tuple(int(x) for x in body.split(","))
    return out


@pytest.fixture(scope="module")
def ten_ant():
    return TenAntEnv(device="cpu")


def test_source_tree_is_the_wrappers_tree():
    assert _compiled_tree() == fs.KERNEL_TREE


@pytest.mark.parametrize("table", ["TenAnt", "TenAnt no box", "TenAnt legacy", "OneAnt",
                                   "debug tool"])
def test_baked_tables_carry_the_compiled_tree(ten_ant, table):
    spec = ten_ant.spec
    if table == "TenAnt no box":
        spec = spec._replace(box_sys=None, box_half_extents=None)
    elif table == "TenAnt legacy":
        spec = spec._replace(contact=spec.contact._replace(beta=None))
    if table == "OneAnt":
        c = OneAntEnv(device="cpu").substep_consts
    elif table == "debug tool":
        c = debug_fused.kernel_consts(spec.ant_sys, True, clamp=False)
    else:
        c = fs.scene_consts(spec)
    assert c.P == _compiled_tree()["point_start"][-1] == 37
    assert fs.table_tree(c) == _compiled_tree()
    fs.check_kernel_tree(c)


def _altered(c, field, k, value):
    """A copy of table c whose baked field `field` has entry k set to value
    (the flat table, its float view and the plain version's tuples alike)."""
    off = sum(n for name, n in sp.table_layout(c.P)[:[x for x, _ in sp.table_layout(c.P)]
                                                     .index(field)])
    table = c.table.clone()
    table[off + k] = value
    f = {name: list(v) for name, v in c.f.items()}
    f[field][k] = float(value)
    parent = list(c.parent)
    if field == "parent":
        parent[k] = int(value)
    return dataclasses.replace(c, table=table, f=f, parent=tuple(parent), _device_tables={})


@pytest.mark.parametrize("field,k,value", [("parent", 4, 1), ("point_start", 2, 17),
                                           ("chain_mask", 9, 63 | 256), ("body_sensor", 4, -1)])
def test_a_table_with_another_tree_is_refused(ten_ant, field, k, value):
    """Refused by the check, and by the wrappers' table upload, which checks
    a table at its first upload to a device and uploads nothing it refuses
    (the launch count is held on the card in test_torch_fused_substep.py)."""
    c = dataclasses.replace(ten_ant.substep_consts, _device_tables={})
    lib = types.SimpleNamespace(substep_table_len=lambda P: c.table.numel())
    cpu = torch.device("cpu")
    assert fs._device_table(lib, c, cpu) is fs._device_table(lib, c, cpu)
    assert list(c._device_tables) == ["cpu"]
    bad = _altered(c, field, k, value)
    with pytest.raises(ValueError, match=field):
        fs.check_kernel_tree(bad)
    with pytest.raises(ValueError, match=field):
        fs._device_table(lib, bad, cpu)
    assert bad._device_tables == {}


def test_plain_tree_mismatch_is_refused(ten_ant):
    c = ten_ant.substep_consts
    bad = dataclasses.replace(c, body_of_dof=(0,) * 6 + (1, 2, 3, 4, 5, 6, 8, 7),
                              _device_tables={})
    with pytest.raises(ValueError, match="body_of_dof"):
        fs.check_kernel_tree(bad)
    bad = dataclasses.replace(c, parent=(-1, 0, 1, 0, 3, 0, 5, 0, 5), _device_tables={})
    with pytest.raises(ValueError, match="parent"):
        fs.check_kernel_tree(bad)
    sensors = list(c.point_sensor)
    sensors[-1] = -1
    bad = dataclasses.replace(c, point_sensor=tuple(sensors), _device_tables={})
    with pytest.raises(ValueError, match="point_sensor"):
        fs.check_kernel_tree(bad)

