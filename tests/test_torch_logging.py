"""The port's metrics files against the JAX package's, on the CPU.

* native/TBEventWriter (the port's copy of tbevents.cc, built into
  build/native/) writes the same bytes as the JAX package's writer for the
  same tag, value, step and wall time, under the same file name (time.time
  patched in both), and tensorboard's EventAccumulator reads it back.
* utils/logging.Writer: the CSV (header once, one row per scalar, appended
  across writers), the tfevents backend chosen as the JAX writer chooses it
  (native, else torch's SummaryWriter, else none), and fetch_metrics.
"""
import csv
import os
import time

import pytest
import torch

from massive_marl_tpu import native as j_native
from massive_marl_tpu_torch import native as p_native
from massive_marl_tpu_torch.utils import logging as p_logging

SCALARS = [("Train2/mean_reward/step", 1.5, 0, None), ("Loss/value_function", -2.25e-3, 1, None),
           ("Perf/fps", 123456.0, 2, 1700000000.25), ("train_episode_rewards", 7.0, 2 ** 40, None)]


def _write(writer_cls, log_dir):
    w = writer_cls(str(log_dir))
    for tag, value, step, wall in SCALARS:
        w.add_scalar(tag, value, step, wall)
    w.close()
    return w.path


def test_tbevents_bytes_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1799999999.5)
    port = _write(p_native.TBEventWriter, tmp_path / "port")
    ref = _write(j_native.TBEventWriter, tmp_path / "jax")
    assert os.path.basename(port) == os.path.basename(ref)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    lib = p_native.build_lib("tbevents.cc")
    assert os.path.dirname(lib) == p_native.BUILD_DIR and os.path.basename(lib).startswith(
        "libtbevents_")
    assert p_native.build_lib("tbevents.cc") == lib       # keyed by the source: reused


def test_tbevents_readable_by_tensorboard(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    _write(p_native.TBEventWriter, tmp_path)
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert sorted(acc.Tags()["scalars"]) == sorted(t for t, *_ in SCALARS)
    for tag, value, step, wall in SCALARS:
        (ev,) = acc.Scalars(tag)
        assert ev.step == step and ev.value == pytest.approx(value, rel=1e-7)
        if wall is not None:
            assert ev.wall_time == wall


def test_writer_csv_and_backends(tmp_path, monkeypatch):
    w = p_logging.Writer(str(tmp_path))
    assert type(w._tb).__name__ == "TBEventWriter"
    w.add_scalar("train/mean_reward", 0.125, 3)
    w.close()
    w2 = p_logging.Writer(str(tmp_path), use_tensorboard=False)
    assert w2._tb is None
    w2.add_scalar("perf/fps", 1234567.0, 4)
    w2.close()
    with open(tmp_path / "metrics.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["wall_time", "step", "tag", "value"]
    assert [r[1:] for r in rows[1:]] == [["3", "train/mean_reward", "0.125"],
                                         ["4", "perf/fps", "1.23457e+06"]]
    assert len([f for f in os.listdir(tmp_path) if f.startswith("events.out.tfevents")]) == 1

    def no_native(log_dir):
        raise RuntimeError("no g++")
    monkeypatch.setattr(p_native, "TBEventWriter", no_native)
    w3 = p_logging.Writer(str(tmp_path / "fallback"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        SummaryWriter = type(None)
    assert isinstance(w3._tb, SummaryWriter)
    w3.close()


def test_fetch_metrics_one_copy():
    m = {"a": torch.tensor(1.5), "n": torch.tensor(3, dtype=torch.int64), "f": 0.25,
         "lr": torch.tensor([2e-4])}
    got = p_logging.fetch_metrics(m)
    assert list(got) == ["a", "n", "f", "lr"]
    assert got == {"a": 1.5, "n": 3.0, "f": 0.25, "lr": pytest.approx(2e-4)}
    assert all(type(v) is float for v in got.values())
