"""The port and its chip smoke script import nothing of JAX, flax, optax,
PyYAML, msgpack or the JAX package (the GPU host has none of them)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "yaml", "msgpack", "massive_marl_tpu"}
FILES = sorted((ROOT / "massive_marl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_side_imports(path):
    bad = sorted({m for m in imported_modules(ast.parse(path.read_text()))
                  if m.split(".")[0] in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("chip_smoke.py", "massive_marl_tpu_torch/ops/fused_substep.py",
                 "massive_marl_tpu_torch/algos/rl/ppo.py", "massive_marl_tpu_torch/cli/train.py",
                 "massive_marl_tpu_torch/ops/fused_mlp.py",
                 "massive_marl_tpu_torch/algos/marl/nets.py",
                 "massive_marl_tpu_torch/algos/marl/fused_nets.py",
                 "massive_marl_tpu_torch/algos/marl/runner.py",
                 "massive_marl_tpu_torch/algos/marl/recurrent_runner.py",
                 "massive_marl_tpu_torch/algos/marl/mat.py",
                 "massive_marl_tpu_torch/algos/marl/maddpg.py",
                 "massive_marl_tpu_torch/wrap/vec_task.py",
                 "massive_marl_tpu_torch/utils/tree.py",
                 "massive_marl_tpu_torch/utils/msgpack_lite.py",
                 "massive_marl_tpu_torch/utils/checkpoint.py",
                 "massive_marl_tpu_torch/utils/bridge.py",
                 "massive_marl_tpu_torch/utils/logging.py",
                 "massive_marl_tpu_torch/utils/viewer.py",
                 "massive_marl_tpu_torch/utils/registry.py",
                 "massive_marl_tpu_torch/utils/config.py",
                 "massive_marl_tpu_torch/native/__init__.py",
                 "massive_marl_tpu_torch/algos/rl/trpo.py",
                 "massive_marl_tpu_torch/algos/rl/offpolicy.py",
                 "massive_marl_tpu_torch/envs/multi_ant_circle.py",
                 "massive_marl_tpu_torch/envs/multi_ingenuity.py",
                 "massive_marl_tpu_torch/wrap/multi_task_vec_task.py",
                 "massive_marl_tpu_torch/phys/mjcf.py",
                 "massive_marl_tpu_torch/algos/mtrl/mtppo.py",
                 "massive_marl_tpu_torch/algos/mtrl/mttrpo.py",
                 "massive_marl_tpu_torch/algos/mtrl/mtsac.py",
                 "massive_marl_tpu_torch/algos/metarl/maml.py",
                 "massive_marl_tpu_torch/algos/offrl/__init__.py",
                 "massive_marl_tpu_torch/algos/offrl/collect.py",
                 "massive_marl_tpu_torch/algos/offrl/datasets.py",
                 "massive_marl_tpu_torch/algos/offrl/trainers.py",
                 "massive_marl_tpu_torch/parallel/__init__.py",
                 "massive_marl_tpu_torch/parallel/mesh.py",
                 "massive_marl_tpu_torch/parallel/launch.py",
                 "massive_marl_tpu_torch/utils/profiling.py",
                 "massive_marl_tpu_torch/utils/logger/__init__.py",
                 "massive_marl_tpu_torch/utils/logger/tools.py",
                 "massive_marl_tpu_torch/utils/logger/plotter.py"):
        assert must in names
    tree = ast.parse("import jax.numpy as jnp\nfrom massive_marl_tpu.phys import mjcf\n"
                     "import importlib\nimportlib.import_module('flax')\nimport msgpack\n")
    assert sorted(m.split(".")[0] for m in imported_modules(tree)) == \
        ["flax", "importlib", "jax", "massive_marl_tpu", "msgpack"]
