"""Shared launcher plumbing (port of oakink2_tamf_tpu/launch/common.py:39-301):
config boot, dataset and loader construction, CLIP text features, moving a
batch to the device.

The real-data dataset (data/segment.py) is not ported yet: `build_dataset`
serves the synthetic segments and raises for anything else.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Any

import numpy as np
import torch

from ..data.collate import SegmentCollate
from ..data.loader import DataLoader
from ..data.synthetic import SyntheticSegments
from ..models.clip_text import FrozenClipText
from ..runtime import logging as RL
from ..runtime.ckpt import RunDir
from ..runtime.config import ConfigRegistry, sync_global_timestamp

_logger = logging.getLogger(__name__)


def boot(prog: str, register_fns, argv=None) -> tuple[ConfigRegistry, RunDir]:
    """Parse the config, set up the run dir and logging: (registry, run_dir)."""
    sync_global_timestamp()
    reg = ConfigRegistry(prog)
    for fn in register_fns:
        fn(reg)
    parser = argparse.ArgumentParser(prog=prog)
    reg.hook(parser)
    reg.parse(parser, argv)

    RL.log_init()
    RL.enable_console()
    RL.suppress_noisy()
    _logger.info("cmd: %s", " ".join(sys.argv if argv is None else [prog, *argv]))

    run_dir = RunDir(prog, exp_id=reg.select("exp_id"), commit=reg.values.get("commit", False))
    run_dir.setup()
    if run_dir.commit:
        RL.enable_file(run_dir.log_file)
    run_dir.dump_opt(config={k: _plain(v) for k, v in reg.values.items()})
    _logger.info("prog=%s exp_id=%s commit=%s", prog, run_dir.exp_id, run_dir.commit)
    return reg, run_dir


def _plain(v: Any):
    import yaml

    try:
        yaml.safe_dump(v)
        return v
    except yaml.YAMLError:
        return repr(v)


def build_dataset(reg: ConfigRegistry, split: str):
    """The split's dataset. Synthetic segments (data.synthetic: true) are
    capped at 2 object slots and 512 points, as in the JAX package."""
    data_cfg = reg.select("data")
    if data_cfg.get("synthetic"):
        return SyntheticSegments(
            size=int(data_cfg.get("synthetic_size", 64)),
            seq_len=int(data_cfg.get("synthetic_seq_len", 160)),
            max_nobj=min(int(data_cfg.get("max_nobj", 4)), 2),
            n_obj_points=min(int(data_cfg.get("n_obj_points", 2048)), 512),
        )
    raise NotImplementedError(
        "the real-data dataset (OakInk2 segments, data/segment.py, slice.py, adaptors.py) "
        "is not ported yet; run with --data.synthetic true"
    )


def build_loader(reg: ConfigRegistry, dataset, split: str, *, shuffle=None, drop_last=None) -> DataLoader:
    data_cfg = reg.select("data")
    bs = reg.select(split).get("batch_size", 8)
    return DataLoader(
        dataset,
        batch_size=int(bs),
        collate_fn=SegmentCollate(
            max_nobj=int(data_cfg.get("max_nobj", 4)),
            n_obj_points=int(data_cfg.get("n_obj_points", 2048)),
        ),
        shuffle=(split == "train") if shuffle is None else shuffle,
        drop_last=(split == "train") if drop_last is None else drop_last,
        seed=int(reg.select("runtime").get("seed", 0)),
        num_workers=int(reg.select("runtime").get("num_worker", 2)),
    )


def build_eval_loaders(reg: ConfigRegistry, wrap=None) -> dict[str, DataLoader]:
    """val/test loaders: a split is built only when configured (synthetic
    data, a cache dict or a process range); a configured split that fails
    to build raises; drop_last=False so the whole split is evaluated.
    `wrap(split, dataset)` adapts the dataset before the loader (R's sample
    adaptors)."""
    loaders: dict[str, DataLoader] = {}
    data_cfg = reg.select("data")
    for split in ("val", "test"):
        split_cfg = reg.select(split)
        if not (data_cfg.get("synthetic") or split_cfg.get("cache_dict_filepath")
                or split_cfg.get("process_range")):
            _logger.info("%s split not configured; skipping its eval", split)
            continue
        ds = build_dataset(reg, split)
        if wrap is not None:
            ds = wrap(split, ds)
        ld = build_loader(reg, ds, split, shuffle=False, drop_last=False)
        if len(ld):
            loaders[split] = ld
        else:
            _logger.warning("%s split is configured but EMPTY; no eval for it", split)
    return loaders


def build_clip(reg: ConfigRegistry, device: torch.device) -> FrozenClipText:
    try:
        clip_cfg = reg.select("clip")
    except KeyError:
        clip_cfg = {}
    return FrozenClipText(
        checkpoint_path=clip_cfg.get("checkpoint_path") or None,
        bpe_path=clip_cfg.get("bpe_path") or None,
        device=device,
    )


def attach_text_emb(batch: dict[str, Any], clip: FrozenClipText) -> dict[str, Any]:
    """batch['text'] -> batch['text_emb'] [bs, 512] on the CLIP device (cached
    per prompt; cloned out of inference mode so autograd may save it)."""
    if "text_emb" not in batch:
        batch = dict(batch)
        batch["text_emb"] = clip.encode_text(batch["text"]).clone()
    return batch


DEVICE_BATCH_KEYS = (
    "pose_repr", "sample_pose_repr", "mask", "shape", "hand_side", "text_emb",
    "obj_traj", "obj_embedding", "obj_mask", "obj_points", "action_label_id",
    "target_h2o", "gt_o2h", "gt_h2o",
)


def device_batch(batch: dict[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    """The array keys of a collated batch as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(device)
            for k, v in batch.items() if k in DEVICE_BATCH_KEYS}
