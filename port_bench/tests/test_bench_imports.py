"""Nothing under port_bench/ imports the JAX stack or the JAX package, by
whole top-level module name (the port's name begins with the JAX
package's), and the reference imports nothing of the port."""
import ast
import os
import subprocess
import sys

from port_bench import harness

BANNED = {"jax", "jaxlib", "flax", "massive_marl_tpu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(top):
    for root, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_module_of_the_jax_stack_or_the_jax_package():
    for path in _sources(harness.HERE):
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED, (path, name)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(harness.HERE, "reference")):
        for name in _imports(path):
            assert name.split(".")[0] != "massive_marl_tpu_torch", (path, name)


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "massive_marl_tpu_torch_x", sys)
    assert "massive_marl_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.banned_modules()


def test_the_command_refuses_without_a_card():
    if subprocess.run([sys.executable, "-c", "import torch,sys; "
                       "sys.exit(torch.cuda.is_available())"]).returncode:
        return  # a card is there: the cuda-marked runs cover the command
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        "tenant-ppo.e4096", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
