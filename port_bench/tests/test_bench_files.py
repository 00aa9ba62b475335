"""BENCHMARK.json and the files it names load and resolve."""
import json
import os
import re

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_loads_with_its_configuration_and_traffic():
    bench = harness.benchmark()
    used = set()
    for w in bench["workloads"]:
        cell, config = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert config["name"] == w["config"]
        assert set(cell["limits"]) == {"loss", "grad", "change"}
        assert cell["num_envs"] > 0
        assert 1 <= cell["checked_iterations"] <= cell["warmup_iterations"]
        harness.trainer_module(config)
        used.add(w["config"])
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/")
        with open(os.path.join(harness.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_every_per_layer_metric_has_a_reader_and_names_are_valid():
    bench = harness.benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]).read)
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1


def test_metrics_of_follows_the_workloads_key():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert [m["name"] for m in harness.metrics_of(bench, "x", "end_to_end")] == ["a", "b"]
    assert [m["name"] for m in harness.metrics_of(bench, "y", "end_to_end")] == ["a"]
