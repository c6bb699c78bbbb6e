"""Shared launcher plumbing (port of oakink2_tamf_tpu/launch/common.py:39-301):
config boot with the process group, the run's device, dataset and loader
construction, CLIP text features, moving a batch to the device, the
samplers' sharding and segment infos, and the activation a checkpoint must
run under.

Several processes (one per card, or on the CPU) run under torchrun, which
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc_per_node 2 -m oakink2_tamf_tpu_torch.launch.train_r --cfg ... [--runtime.device cpu]

`boot` joins the group (maybe_init_distributed) and raises where the JAX
package would go on as one process.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Any

import numpy as np
import torch

from ..data.collate import SegmentCollate
from ..data.loader import DataLoader
from ..data.segment import InteractionSegmentData
from ..data.synthetic import SyntheticSegments
from ..models.clip_text import FrozenClipText
from ..parallel import mesh
from ..runtime import logging as RL
from ..runtime import profiler as P
from ..runtime.ckpt import RunDir, is_jax_checkpoint, read_model_state_dict
from ..runtime.logging import MetricWriter
from ..runtime.config import ConfigRegistry, sync_global_timestamp

_logger = logging.getLogger(__name__)


def boot(prog: str, register_fns, argv=None) -> tuple[ConfigRegistry, RunDir]:
    """Parse the config, join the process group under torchrun, set up the
    run dir and logging: (registry, run_dir). Every rank parses; rank 0's
    start time stamps `?(ts)` for all of them; only rank 0 writes the run's
    opt.yml and log file."""
    reg = ConfigRegistry(prog)
    for fn in register_fns:
        fn(reg)
    parser = argparse.ArgumentParser(prog=prog)
    reg.hook(parser)
    reg.parse(parser, argv)
    maybe_init_distributed(reg)
    if mesh.world_size() > 1:
        sync_global_timestamp()
        reg.parse(parser, argv)  # ?(ts) again, with rank 0's stamp

    RL.log_init()
    RL.enable_console()
    RL.suppress_noisy()
    _logger.info("cmd: %s", " ".join(sys.argv if argv is None else [prog, *argv]))

    run_dir = RunDir(prog, exp_id=reg.select("exp_id"), commit=reg.values.get("commit", False))
    run_dir.setup()
    if mesh.is_coordinator():
        if run_dir.commit:
            RL.enable_file(run_dir.log_file)
        run_dir.dump_opt(config={k: _plain(v) for k, v in reg.values.items()})
    _logger.info("prog=%s exp_id=%s commit=%s", prog, run_dir.exp_id, run_dir.commit)
    if mesh.is_live():
        _logger.info("process group: rank %d of %d (%s)", mesh.rank(), mesh.world_size(),
                     torch.distributed.get_backend())
    return reg, run_dir


def run_device(reg: ConfigRegistry):
    """The run's device: runtime.device ("cuda" = the card of LOCAL_RANK),
    through mesh.local_device. Raises without a GPU unless told "cpu", when
    LOCAL_RANK has no card, and when runtime.device_count (the JAX
    package's mesh size; 0 = any) differs from the world size."""
    runtime = reg.select("runtime")
    dev = mesh.local_device(runtime.get("device") or "cuda")
    count = int(runtime.get("device_count") or 0)
    if count and count != mesh.world_size():
        raise ValueError(
            f"runtime.device_count {count} but {mesh.world_size()} process(es): the port runs one "
            "process per device (torchrun --nproc_per_node)"
        )
    return dev


TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def maybe_init_distributed(reg: ConfigRegistry) -> None:
    """Join the torch.distributed group that torchrun describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT;
    JAX launch/common.py:71-85), then check the run's device against it
    (run_device). Nothing to join without RANK and WORLD_SIZE, or when the
    caller already joined a group. The backend is runtime.dist_backend,
    else NCCL on CUDA and gloo on the CPU (gloo also lets two ranks share
    one card). An incomplete or inconsistent environment and a failed
    rendezvous raise: there is no fallback to one process."""
    env = os.environ
    if not mesh.is_live() and ("RANK" in env or "WORLD_SIZE" in env):
        missing = [k for k in TORCHRUN_ENV if k not in env]
        if missing:
            raise RuntimeError(f"incomplete torchrun environment: {', '.join(missing)} unset")
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        if not 0 <= rank < world:
            raise RuntimeError(f"RANK {rank} out of range for WORLD_SIZE {world}")
        runtime = reg.select("runtime")
        dev = mesh.local_device(runtime.get("device") or "cuda")
        backend = str(runtime.get("dist_backend") or ("nccl" if dev.type == "cuda" else "gloo"))
        mesh.init_distributed(backend=backend, init_method=f"tcp://{env['MASTER_ADDR']}:{int(env['MASTER_PORT'])}",
                              world_size=world, rank=rank, device=dev)
    run_device(reg)


def precompute_cache(cache) -> None:
    """Fill a per-sample cache (data/target_cache.py) before the first
    step. With a cache_dir the ranks split the indices into stripes and
    wait for each other; an in-memory cache is private to its process, so
    every rank computes all of it (JAX launch/train_r.py:130-147)."""
    W = mesh.world_size()
    if cache.cache_dir:
        cache.precompute(shard_index=mesh.rank(), num_shards=W)
        mesh.barrier()
        return
    if W > 1:
        _logger.warning(
            "%s is in-memory on %d processes: each computes all %d segments; a shared "
            "cache dir would split the work", cache._log_label, W, len(cache),
        )
    cache.precompute()


def metric_writer(run_dir: RunDir) -> MetricWriter:
    """The run's summary writer: on rank 0 of a committed run, else a no-op."""
    on = bool(run_dir.commit) and mesh.is_coordinator()
    return MetricWriter(run_dir.sub("summary") if on else None, enabled=on)


def _plain(v: Any):
    import yaml

    try:
        yaml.safe_dump(v)
        return v
    except yaml.YAMLError:
        return repr(v)


def build_dataset(reg: ConfigRegistry, split: str, toolkit: Any = None):
    """The split's dataset. Synthetic segments (data.synthetic: true) are
    capped at 2 object slots and 512 points, as in the JAX package;
    otherwise the OakInk2 segments of data/segment.py from the split's
    cache_dict_filepath (or process_range through a toolkit) and the
    data.* object stores, reversed copies appended on the train split when
    data.append_reverse_segment is set. `toolkit` (oakink2_toolkit's
    interface) serves process_range extraction and, with
    data.enable_obj_model, the object meshes."""
    data_cfg = reg.select("data")
    split_cfg = reg.select(split)
    if data_cfg.get("synthetic"):
        return SyntheticSegments(
            size=int(data_cfg.get("synthetic_size", 64)),
            seq_len=int(data_cfg.get("synthetic_seq_len", 160)),
            max_nobj=min(int(data_cfg.get("max_nobj", 4)), 2),
            n_obj_points=min(int(data_cfg.get("n_obj_points", 2048)), 512),
        )
    kwargs: dict[str, Any] = dict(
        process_range_list=split_cfg.get("process_range") or [],
        data_prefix=data_cfg.get("data_prefix") or None,
        obj_embedding_prefix=data_cfg.get("obj_embedding_prefix") or None,
        obj_pointcloud_prefix=data_cfg.get("obj_pointcloud_prefix") or None,
        enable_obj_model=bool(data_cfg.get("enable_obj_model")),
        cache_dict_filepath=split_cfg.get("cache_dict_filepath") or None,
        toolkit=toolkit,
    )
    if split == "train":
        kwargs["append_reverse_segment"] = bool(data_cfg.get("append_reverse_segment"))
    return InteractionSegmentData(**kwargs)


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


def build_eval_loaders(reg: ConfigRegistry, wrap=None, toolkit: Any = None) -> dict[str, DataLoader]:
    """val/test loaders: a split is built only when configured (synthetic
    data, a cache dict or a process range); a configured split that fails
    to build raises; drop_last=False so the whole split is evaluated.
    `wrap(split, dataset)` adapts the dataset before the loader (R's sample
    adaptors, the encoder's action adapter); `toolkit` goes to
    build_dataset."""
    loaders: dict[str, DataLoader] = {}
    data_cfg = reg.select("data")
    for split in ("val", "test"):
        split_cfg = reg.select(split)
        if not (data_cfg.get("synthetic") or split_cfg.get("cache_dict_filepath")
                or split_cfg.get("process_range")):
            _logger.info("%s split not configured; skipping its eval", split)
            continue
        ds = build_dataset(reg, split, toolkit=toolkit)
        if wrap is not None:
            ds = wrap(split, ds)
        ld = build_loader(reg, ds, split, shuffle=False, drop_last=False)
        if len(ld):
            loaders[split] = ld
        else:
            _logger.warning("%s split is configured but EMPTY; no eval for it", split)
    return loaders


def resolve_shard(sample_cfg) -> tuple[int, int]:
    """(shard_index, num_shards) for the samplers: sample.num_shards /
    sample.shard_index override; otherwise the torch.distributed world size
    and rank when a process group is initialised, else (0, 1). An index out
    of range raises (a clamped slice would drop segments silently)."""
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    W = int(sample_cfg.get("num_shards", 0) or 0) or (dist.get_world_size() if live else 1)
    w = sample_cfg.get("shard_index", None)
    w = (dist.get_rank() if live else 0) if w is None or int(w) < 0 else int(w)
    if not 0 <= w < W:
        raise ValueError(f"sample.shard_index {w} out of range for num_shards {W}")
    return w, W


def segment_infos(dataset) -> list[tuple]:
    """Per-index segment info tuples without building the samples where
    possible: follows `.base` down to a segment store with an aligned
    `info_list` and `len_list` (an adaptor's own info_list is its sample
    provenance and has no len_list); otherwise fetches each sample."""
    n = len(dataset)
    d = dataset
    for _ in range(8):
        info_l = getattr(d, "info_list", None)
        if info_l is not None and hasattr(d, "len_list") and len(info_l) == n:
            return [tuple(i) for i in info_l]
        nxt = getattr(d, "base", None)
        if nxt is None or len(nxt) != n:
            break
        d = nxt
    return [tuple(dataset[i]["info"]) for i in range(n)]


PORT_ACTIVATION = "gelu_exact"  # torch's F.gelu, the reference trunk's activation


def activation_for_checkpoint(reg, filepath) -> str | None:
    """The activation a net must be built with to run the weights in
    `filepath`, or None for the config's `model.activation`. The file
    decides: a bare state_dict is a reference checkpoint, trained under
    torch's exact-erf GELU, so "gelu_exact" (with a warning when the config
    says otherwise); the port's own {step, model, optimizer} checkpoint and
    the JAX package's `.ckpt` were trained under the config's activation."""
    if not filepath or is_jax_checkpoint(filepath):
        return None
    _, own = read_model_state_dict(filepath)
    if own:
        return None
    cfg = str(reg.select("model").get("activation", "gelu"))
    if cfg != PORT_ACTIVATION:
        _logger.warning(
            "reference checkpoint %s: forcing activation=%s (config had %r): the "
            "reference's F.gelu is the exact erf form", filepath, PORT_ACTIVATION, cfg,
        )
    return PORT_ACTIVATION


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
    with P.span("batch.h2d", device=True):
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v).to(device)
                for k, v in batch.items() if k in DEVICE_BATCH_KEYS}


def epoch_rate(steps: int, rows_per_step: int, t_epoch: float, device) -> tuple[float, float]:
    """(seconds, rows per second) of an epoch of `steps` steps begun at
    `t_epoch` (time.time()), read after one synchronise of a CUDA device, so
    that the rate counts the device's work and not only its enqueue."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.time() - t_epoch
    return seconds, steps * rows_per_step / seconds
