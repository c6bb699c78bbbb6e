"""Run directory and checkpoints (port of oakink2_tamf_tpu/runtime/ckpt.py).

Directory contract of the reference (dev_fn/upkeep/ckpt.py:62-149):
  common/<prog>/<exp_id>/{log.txt, opt.yml, summary/, save/}
with `?(ts)`-stamped exp_ids, opt.yml rotation up to .99, and the `commit`
dry-run flag: nothing is written unless --commit is passed.

Checkpoints are `torch.save` files of {step, model, optimizer}: the model's
state_dict in the reference key layout, the AdamW and MultiStepLR states.
Unlike the reference, the step counter is saved, so a resumed run keeps its
learning-rate schedule. A reference checkpoint is a bare state_dict in the
same key layout; `read_model_state_dict` tells the two apart by content.

A `.ckpt` is the JAX package's checkpoint (its launchers' model_XXXX.ckpt:
weights, AdamW moments, step and LR schedule), read through
interop/from_jax wherever a `.pt` is; `save_checkpoint` writes a port
TrainState in that format for the JAX package to resume.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import time
from typing import Any, Optional

import torch

from ..interop import from_jax, to_jax
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


def is_jax_checkpoint(path: str) -> bool:
    """Whether `path` names a JAX package checkpoint: a `.ckpt` file (or an
    orbax directory, which interop/from_jax refuses with its reason)."""
    return str(path).rstrip("/").endswith((".ckpt", ".orbax")) or os.path.isdir(path)


def _load_model(model: torch.nn.Module, sd: dict[str, Any], strict: bool) -> None:
    res = model.load_state_dict(sd, strict=strict)
    if res.missing_keys:
        _logger.info("checkpoint missing keys (kept init): %s", res.missing_keys[:8])
    if res.unexpected_keys:
        _logger.info("checkpoint unexpected keys (ignored): %s", res.unexpected_keys[:8])


def load_checkpoint(path: str, state, strict: bool = False):
    """Restore a checkpoint (the port's `.pt` or the JAX package's `.ckpt`)
    into `state` (in place; also returned). With strict=False, missing and
    unexpected model keys are tolerated and reported (the reference's
    load_state_dict(strict=False)), and the optimizer state is restored
    only when the file has it."""
    if is_jax_checkpoint(path):
        ck = from_jax.read_jax_checkpoint(path)
        _load_model(state.model, from_jax.state_dict_from_jax_checkpoint(state.model, ck), strict)
        if ck.mu is not None:
            from_jax.optimizer_state_from_jax_checkpoint(state.model, state.optimizer, ck)
            state.step = ck.step
        elif strict:
            raise KeyError(f"strict load: {path} has no optimizer state")
        return state
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck["model"] if "model" in ck else ck
    _load_model(state.model, {k.removeprefix("module."): v for k, v in sd.items()}, strict)
    if "optimizer" in ck:
        state.optimizer.load_state_dict(ck["optimizer"])
        state.step = int(ck.get("step", 0))
    elif strict:
        raise KeyError(f"strict load: {path} has no optimizer state")
    return state


def save_checkpoint(path: str, state) -> None:
    """Write a port TrainState as the JAX package's checkpoint (the pickle
    its runtime/ckpt.save_checkpoint writes for a TrainState: interop/
    to_jax.train_state_flat), which its launchers resume from with
    --train.reload_ckpt_model_filepath; written to a temporary file first."""
    flat = to_jax.train_state_flat(state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(flat, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def read_model_state_dict(path: str, module: Optional[torch.nn.Module] = None) -> tuple[dict[str, Any], bool]:
    """(model state_dict, whether the file is a train checkpoint of this
    package or of the JAX package). A dict with a "model" entry is the
    port's own {step, model, optimizer}; a `.ckpt` is the JAX package's,
    converted for `module` (G, R or the FID encoder, which it needs);
    anything else is a reference checkpoint: a bare state_dict (or a
    pickled module), DDP's "module." prefix stripped."""
    if is_jax_checkpoint(path):
        if module is None:
            raise ValueError(f"{path}: a JAX package checkpoint is converted for the module it loads into")
        return from_jax.state_dict_from_jax_checkpoint(module, from_jax.read_jax_checkpoint(path)), True
    ck = torch.load(path, map_location="cpu", weights_only=False)
    own = isinstance(ck, dict) and "model" in ck
    sd = ck["model"] if own else ck
    if not isinstance(sd, dict):
        sd = sd.state_dict()
    return {k.removeprefix("module."): v for k, v in sd.items()}, own


def load_model_weights(module: torch.nn.Module, path: str) -> None:
    """Load a model's weights from `path` (a port train checkpoint, a JAX
    package `.ckpt` or a reference state_dict) into `module`; keys the
    module does not have (e.g. the reference's clip_model.*) are ignored, a
    key the module needs but the file lacks raises."""
    sd, _ = read_model_state_dict(path, module)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} keys, e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k] for k in own})
