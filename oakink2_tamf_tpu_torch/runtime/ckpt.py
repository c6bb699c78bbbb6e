"""Run directory and checkpoints (port of oakink2_tamf_tpu/runtime/ckpt.py).

Directory contract of the reference (dev_fn/upkeep/ckpt.py:62-149):
  common/<prog>/<exp_id>/{log.txt, opt.yml, summary/, save/}
with `?(ts)`-stamped exp_ids, opt.yml rotation up to .99, and the `commit`
dry-run flag: nothing is written unless --commit is passed.

Checkpoints are `torch.save` files of {step, model, optimizer}: the model's
state_dict in the reference key layout, the AdamW and MultiStepLR states.
Unlike the reference, the step counter is saved, so a resumed run keeps its
learning-rate schedule.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Any, Optional

import torch

from . import config as _config
from .config import substitute

_logger = logging.getLogger(__name__)


def default_exp_id(prog: str) -> str:
    # read via the module: sync_global_timestamp() may rebind the stamp
    return f"{prog}__" + time.strftime("%Y_%m%d_%H%M_%S", time.localtime(_config.GLOBAL_TIMESTAMP))


def ckpt_path_for(prog: str, exp_id: str, root: str = ".") -> str:
    """Absolute `<root>/common/<prog>/<exp_id>` (anchored at the CWD, as the
    reference's upkeep/ckpt.py:67-76)."""
    return os.path.abspath(os.path.join(root, "common", prog, exp_id))


def rotate_file(path: str, limit: int = 100) -> None:
    """Shift path -> path.00, path.00 -> path.01, ... up to .99 (drop oldest)."""
    if not os.path.exists(path):
        return
    slots = [f"{path}.{i:02d}" for i in range(limit)]
    if os.path.exists(slots[-1]):
        os.remove(slots[-1])
    for i in range(limit - 2, -1, -1):
        if os.path.exists(slots[i]):
            shutil.move(slots[i], slots[i + 1])
    shutil.move(path, slots[0])


class RunDir:
    """A run directory with dry-run gating."""

    def __init__(self, prog: str, exp_id: Optional[str] = None, commit: bool = False, root: str = "."):
        self.prog = prog
        self.exp_id = substitute(exp_id, prog) if exp_id else default_exp_id(prog)
        self.commit = commit
        self.path = ckpt_path_for(prog, self.exp_id, root)

    def setup(self) -> None:
        if self.commit:
            os.makedirs(self.path, exist_ok=True)
            _logger.info("commit mode: setup ckpt at %s", self.path)
        else:
            _logger.info("dry run mode")

    def sub(self, name: str) -> str:
        p = os.path.join(self.path, name)
        if self.commit:
            os.makedirs(p, exist_ok=True)
        return p

    @property
    def log_file(self) -> str:
        return os.path.join(self.path, "log.txt")

    def dump_opt(self, **cfg: Any) -> None:
        """Full config provenance -> opt.yml with rotation."""
        if not self.commit:
            return
        import yaml

        opt_file = os.path.join(self.path, "opt.yml")
        rotate_file(opt_file)
        with open(opt_file, "w") as f:
            yaml.dump(cfg, f, sort_keys=False)


def save_train_state(save_dir: str, epoch: int, state, prefix: str = "model") -> str:
    """<save_dir>/<prefix>_{epoch:04d}.pt (reference: save/model_{epoch:04d}.pt)
    holding {step, model, optimizer}; written to a temporary file first."""
    path = os.path.join(save_dir, f"{prefix}_{epoch:04d}.pt")
    os.makedirs(save_dir, exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state, strict: bool = False):
    """Restore a checkpoint into `state` (in place; also returned). With
    strict=False, missing and unexpected model keys are tolerated and
    reported (the reference's load_state_dict(strict=False)), and the
    optimizer state is restored only when the file has it."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck["model"] if "model" in ck else ck
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    res = state.model.load_state_dict(sd, strict=strict)
    if res.missing_keys:
        _logger.info("checkpoint missing keys (kept init): %s", res.missing_keys[:8])
    if res.unexpected_keys:
        _logger.info("checkpoint unexpected keys (ignored): %s", res.unexpected_keys[:8])
    if "optimizer" in ck:
        state.optimizer.load_state_dict(ck["optimizer"])
        state.step = int(ck.get("step", 0))
    elif strict:
        raise KeyError(f"strict load: {path} has no optimizer state")
    return state
