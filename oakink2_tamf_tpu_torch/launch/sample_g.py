"""Sample MF-MDM G over a split and save one .npy pose_repr per segment for
R's training (port of oakink2_tamf_tpu/launch/sample_g.py; the reference's
launch/sample.py workflow) on one device; under torchrun, one process per
device (launch/common.run_device), each on its own shard and with no
collective after boot (the JAX package's local mesh per process).

    python -m oakink2_tamf_tpu_torch.launch.sample_g --cfg config/arch_mdm_l.yml \
        --data.synthetic true --sample.model_filepath G.pt [--sample.sampler ddim] \
        [--runtime.device cpu] [--commit]

Output layout (what data/adaptors.GeneratedPoseReprSampleAdaptor reads):
  <sample.save_prefix or the run dir>/sample/<split>/<exp_id>/{index:06d}.npy
each [L, 99], the raw chain output: padded frames are not zeroed here (R's
training and sample_r read them as the adaptor gives them, as in the JAX
package). Each shard (launch/common.resolve_shard) takes a contiguous index
range; every batch holds `sample.batch_size` segments, the tail padded by
repeating its last one; the noise comes from one generator on the device
seeded runtime.seed + shard index. A `.pt` model_filepath is either a
reference state_dict (run under "gelu_exact") or the port's own train
checkpoint, and a `.ckpt` the JAX package's (both run under
model.activation): launch/common.activation_for_checkpoint.
Without one, G is randomly initialised from seed 0. Nothing is written
without --commit.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..core import diffusion as D
from ..data.collate import SegmentCollate
from ..parallel import train as PT
from ..runtime.ckpt import load_model_weights
from . import common, param
from .train_g import build_model

_logger = logging.getLogger(__name__)

PROG = "sample_g"


def pad_batch(db: dict[str, torch.Tensor], bs: int) -> dict[str, torch.Tensor]:
    """Each tensor grown to `bs` rows by repeating its last row."""
    return {k: torch.cat([v, v[-1:].expand((bs - v.shape[0],) + tuple(v.shape[1:]))]) if v.shape[0] < bs else v
            for k, v in db.items()}


def main(argv=None) -> str:
    reg, run_dir = common.boot(
        PROG,
        [
            param.reg_base_param,
            param.reg_model_param,
            param.reg_diffusion_param,
            param.reg_clip_param,
            param.reg_sample_param,
        ],
        argv,
    )
    sample_cfg = reg.select("sample")
    runtime = reg.select("runtime")
    split = sample_cfg.get("split", "test")
    device = common.run_device(reg)
    _logger.info("device: %s", device)

    dataset = common.build_dataset(reg, split)
    clip = common.build_clip(reg, device)
    fp = sample_cfg.get("model_filepath") or ""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(reg, activation=common.activation_for_checkpoint(reg, fp))
    if fp:
        load_model_weights(model, fp)
        _logger.info("loaded G from %s", fp)
    model.to(device).eval().requires_grad_(False)
    dcfg = reg.select("diffusion")
    sched = D.tamf_schedule(
        int(dcfg.get("steps", 1000)), str(dcfg.get("noise_schedule", "cosine")),
        str(dcfg.get("timestep_respacing", "")),
    ).to(device)
    sampler = PT.make_g_sampler(
        sched, sampler=sample_cfg.get("sampler", "ddpm"),
        parallel_window=int(sample_cfg.get("parallel_window", 64)),
        parallel_tol=float(sample_cfg.get("parallel_tol", 1e-2)),
    )
    data_cfg = reg.select("data")
    collate = SegmentCollate(
        max_nobj=int(data_cfg.get("max_nobj", 4)),
        n_obj_points=int(data_cfg.get("n_obj_points", 2048)),
    )

    base = sample_cfg.get("save_prefix") or run_dir.path
    out_dir = os.path.join(base, "sample", split, run_dir.exp_id)
    if run_dir.commit:
        os.makedirs(out_dir, exist_ok=True)

    n = len(dataset)
    w, W = common.resolve_shard(sample_cfg)
    indices = list(range((n * w) // W, (n * (w + 1)) // W))
    bs = int(sample_cfg.get("batch_size", 32))
    generator = torch.Generator(device=device).manual_seed(int(runtime.get("seed", 0)) + w)

    for start in range(0, len(indices), bs):
        chunk = indices[start : start + bs]
        batch = common.attach_text_emb(collate([dataset[i] for i in chunk]), clip)
        db = pad_batch(common.device_batch(batch, device), bs)
        out = sampler(model, db, generator)[: len(chunk)].cpu().numpy()
        if run_dir.commit:
            for j, idx in enumerate(chunk):
                np.save(os.path.join(out_dir, f"{idx:06d}.npy"), out[j])
        _logger.info("sampled %d/%d", min(start + bs, len(indices)), len(indices))

    _logger.info("done: %s", out_dir if run_dir.commit else "(dry run, nothing written)")
    return out_dir


if __name__ == "__main__":
    main()
