"""Scalar metric logging: JSONL always, TensorBoard when available.

Counterpart of ``pwcnet_tpu/train_lib/metrics.py``. The reference logs 'loss/pwc' and 'EPE/source' scalars to TensorBoard
FileWriters under ``logs/history_<ts>/{train,val}`` (train.py:101-111).
This logger keeps that directory layout and scalar names, writes an
append-only ``metrics.jsonl`` (greppable, dependency-free), and mirrors to
TensorBoard via torch.utils.tensorboard if importable.
"""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, logdir: str, enable_tensorboard: bool = True):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a")
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.logdir))
            except Exception:
                self._tb = None

    def log(self, step: int, scalars: dict) -> None:
        rec = {"step": int(step)}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
