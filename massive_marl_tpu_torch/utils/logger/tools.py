"""Post-hoc log tooling: tfevents -> csv conversion and run merging (twin
of massive_marl_tpu/utils/logger/tools.py).

It reads the trainers' own files (utils/logging.Writer): metrics.csv, and
the tfevents files of the native writer (native/tbevents.cc) with a small
reader of its own, so nothing beyond the standard library is needed.
"""
from __future__ import annotations

import csv
import os
import struct
from typing import Dict, List


def find_event_files(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.startswith("events.out.tfevents"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _varint(buf: bytes, i: int):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if b < 0x80:
            return v, i


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: ints for
    varints, raw bytes for fixed and length-delimited fields."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        elif wt == 2:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield field, wt, v


def read_tfevents(path: str) -> Dict[str, List[tuple]]:
    """tag -> [(wall_time, step, value)] of the scalar summaries (Event:
    wall_time 1, step 2, summary 5; Summary.value 1; Value: tag 1,
    simple_value 2) in a TFRecord file."""
    out: Dict[str, List[tuple]] = {}
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i + 12 <= len(data):
        (n,) = struct.unpack_from("<Q", data, i)
        rec = data[i + 12:i + 12 + n]
        i += 16 + n
        wall, step, values = 0.0, 0, []
        for field, wt, v in _fields(rec):
            if field == 1 and wt == 1:
                (wall,) = struct.unpack("<d", v)
            elif field == 2 and wt == 0:
                step = v - (1 << 64) if v >= 1 << 63 else v
            elif field == 5 and wt == 2:
                for sf, swt, sv in _fields(v):
                    if sf == 1 and swt == 2:
                        tag, val = None, None
                        for vf, vwt, vv in _fields(sv):
                            if vf == 1 and vwt == 2:
                                tag = vv.decode()
                            elif vf == 2 and vwt == 5:
                                (val,) = struct.unpack("<f", vv)
                        if tag is not None and val is not None:
                            values.append((tag, val))
        for tag, val in values:
            out.setdefault(tag, []).append((wall, step, val))
    return out


def read_metrics_csv(path: str) -> Dict[str, List[tuple]]:
    out: Dict[str, List[tuple]] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            out.setdefault(row["tag"], []).append(
                (float(row["wall_time"]), int(row["step"]), float(row["value"])))
    return out


def convert_tfevents_to_csv(root: str, refresh: bool = False) -> List[str]:
    """Every run dir with tfevents gets a <tag>.csv next to it ('/' in a
    tag becomes '_'); an existing one is kept unless `refresh`."""
    written = []
    for ev in find_event_files(root):
        run_dir = os.path.dirname(ev)
        for tag, rows in read_tfevents(ev).items():
            out_path = os.path.join(run_dir, tag.replace("/", "_") + ".csv")
            if os.path.exists(out_path) and not refresh:
                continue
            with open(out_path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["wall_time", "step", "value"])
                w.writerows(rows)
            written.append(out_path)
    return written


def merge_runs(csv_paths: List[str], out_path: str):
    """Merge per-seed csvs into one long-form csv with a run column (the
    csv's directory name)."""
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run", "wall_time", "step", "value"])
        for p in csv_paths:
            run = os.path.basename(os.path.dirname(p))
            with open(p) as g:
                for row in csv.DictReader(g):
                    w.writerow([run, row["wall_time"], row["step"], row["value"]])
    return out_path

