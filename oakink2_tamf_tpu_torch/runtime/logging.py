"""Logging + metric writers (copy of oakink2_tamf_tpu/runtime/logging.py).

Reference parity (dev_fn/upkeep/log.py, util/summary_writer.py):
- colored console logging + plain file logging with rotation
- coordinator-only metric writer (replaces the rank-0 DDPSummaryWriter):
  JSONL scalar stream (one line per scalar: tag/step/value/walltime) plus a
  TensorBoard writer when the package is importable.
The reference's multiprocessing log Queue fan-in is unnecessary here: the
port trains in one process per device; the coordinator alone writes metrics.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

from .ckpt import rotate_file

_COLORS = {
    logging.DEBUG: "\x1b[38;21m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33;1m",
    logging.ERROR: "\x1b[31;1m",
    logging.CRITICAL: "\x1b[41;1m",
}
_RESET = "\x1b[0m"
_FMT = "%(asctime)s | %(levelname)-7s | %(name)s | %(message)s"


class ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        base = logging.Formatter(_FMT).format(record)
        return f"{color}{base}{_RESET}" if sys.stderr.isatty() else base


def log_init(level: int = logging.INFO) -> None:
    root = logging.getLogger()
    root.setLevel(level)


def enable_console(level: int = logging.INFO) -> None:
    root = logging.getLogger()
    for h in root.handlers:
        if getattr(h, "_tamf_console", False):
            return
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(ColorFormatter())
    h.setLevel(level)
    h._tamf_console = True  # type: ignore[attr-defined]
    root.addHandler(h)


def enable_file(path: str, level: int = logging.INFO) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rotate_file(path)
    h = logging.FileHandler(path)
    h.setFormatter(logging.Formatter(_FMT))
    h.setLevel(level)
    logging.getLogger().addHandler(h)


def suppress_noisy() -> None:
    for name in ("torch._dynamo", "torch.distributed", "PIL"):
        logging.getLogger(name).setLevel(logging.WARNING)


class MetricWriter:
    """Coordinator-gated scalar writer: JSONL + optional TensorBoard."""

    def __init__(self, log_dir: Optional[str], enabled: bool = True):
        self.enabled = enabled and log_dir is not None
        self._jsonl = None
        self._tb = None
        if self.enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1)
            try:
                from torch.utils.tensorboard import SummaryWriter  # type: ignore

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, global_step: int, walltime: float | None = None) -> None:
        if not self.enabled:
            return
        wt = walltime if walltime is not None else time.time()
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(global_step), "walltime": wt})
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), global_step=int(global_step), walltime=wt)

    def add_scalars(self, scalars: dict[str, float], global_step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, global_step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
