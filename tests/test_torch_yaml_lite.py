"""The port's YAML loader (utils/yaml_lite) against PyYAML's safe_load.

Every file under cfg/ loads to what yaml.safe_load gives; so do the forms
of the subset the files do not use yet (quoted scalars, lists level with
their key or holding mappings, the resolver's bool, null, int and float
spellings, comments); and what lies outside the subset raises ValueError
instead of loading to something else.
"""
import math
import pathlib

import pytest
import yaml

from massive_marl_tpu_torch.utils import yaml_lite

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG_FILES = sorted((ROOT / "cfg").rglob("*.yaml"))


@pytest.mark.parametrize("path", CFG_FILES, ids=[str(p.relative_to(ROOT)) for p in CFG_FILES])
def test_cfg_file_loads_as_safe_load(path):
    assert yaml_lite.load(str(path)) == yaml.safe_load(path.read_text())


def test_scan_sees_every_cfg_file():
    assert len(CFG_FILES) >= 24
    assert ROOT / "cfg" / "TenAnt.yaml" in CFG_FILES and ROOT / "cfg" / "ppo" / "config.yaml" \
        in CFG_FILES


SUBSET = [
    "a: 1e-5", "a: 1.0e-05", "a: 5.", "a: .5", "a: -.inf", "a: +1", "a: 1_000", "a: -0",
    "a: yes", "a: Off", "a: ~", "a:", "a: null", "a: hello world", "a: b # comment",
    "a: 'it''s # not a comment'", 'a: "q\\"x\\n" # c', "'k': 1", "a: 1.0e5",
    "a:\n- 1\n- 2\nb: 3", "a:\n  - x: 1\n    y: [z]\n  - 3", "- a\n- b", "x",
    "k:\n  l:\n  - 1\n  m: null\nn: 2", "a:\n-\n- 2", "# only\na: 1  # trailing\n\n",
]


@pytest.mark.parametrize("text", SUBSET)
def test_subset_loads_as_safe_load(text):
    if "[z]" in text:   # a flow list inside is outside the subset
        with pytest.raises(ValueError):
            yaml_lite.loads(text)
        return
    assert yaml_lite.loads(text) == yaml.safe_load(text)


def test_nan_loads():
    assert math.isnan(yaml_lite.loads("a: .nan")["a"])


OUTSIDE = ["a: [1, 2]", "a: {b: 1}", "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  t",
           "a: >\n  t", "a: 012", "a: 0x1f", "a: 0b11", "---\na: 1", "a: 1\n b: 2",
           "a: 2001-12-14", "\ta: 1", "a: 1:20", "a: -", "a: 'open", "a: b: c"]


@pytest.mark.parametrize("text", OUTSIDE)
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        yaml_lite.loads(text)
