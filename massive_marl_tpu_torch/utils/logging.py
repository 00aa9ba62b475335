"""Metrics writer: CSV always, and TensorBoard events when a backend is
there (twin of massive_marl_tpu/utils/logging.py).

The tfevents backend is the native writer (native/tbevents.cc); torch's
SummaryWriter is the fallback when the library cannot be built, and
without either only the CSV is written, as in the JAX package.  Metrics
come to the host once per logged iteration (`fetch_metrics`).
"""
from __future__ import annotations

import csv
import os
import time

import torch


def fetch_metrics(metrics: dict) -> dict:
    """A dict of device scalars as host floats, with one torch.stack and one
    copy to the host (not one synchronizing copy per metric)."""
    keys = list(metrics)
    dev = next((v.device for v in metrics.values() if isinstance(v, torch.Tensor)), "cpu")
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=dev).reshape(())
                        for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


class Writer:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        if use_tensorboard:
            try:
                from massive_marl_tpu_torch.native import TBEventWriter
                self._tb = TBEventWriter(log_dir)
            except Exception:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(log_dir=log_dir, flush_secs=30)
                except Exception:
                    self._tb = None
        self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv_file = open(self._csv_path, "a", newline="")
        self._csv = csv.writer(self._csv_file)
        if os.path.getsize(self._csv_path) == 0:
            self._csv.writerow(["wall_time", "step", "tag", "value"])

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._csv.writerow([f"{time.time():.3f}", step, tag, f"{value:.6g}"])

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        self._csv_file.flush()

    def close(self):
        self.flush()
        if self._tb is not None:
            self._tb.close()
        self._csv_file.close()
