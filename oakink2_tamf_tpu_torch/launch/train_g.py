"""Train MF-MDM G (port of oakink2_tamf_tpu/launch/train_g.py; the reference's
launch/train.py workflow) on one device, or one process per device.

    python -m oakink2_tamf_tpu_torch.launch.train_g --cfg config/arch_mdm_l.yml \
        --cfg config/loss_param.yml --data.synthetic true [--runtime.device cpu] [--commit]
    torchrun --nproc_per_node 2 -m oakink2_tamf_tpu_torch.launch.train_g ...

The YAMLs are the JAX package's. The device is `runtime.device` ("cuda" by
default; without a GPU the run raises unless told "cpu"). Under torchrun
each rank trains on its stripe of the data (train.batch_size rows per
rank) and every step is the global batch's (parallel/train.py); rank 0
alone writes checkpoints, summaries and the trace; the eval pass runs on
every rank over its stripe and rank 0 logs the global means.
`train.data.cache_gt_geom` precomputes the GT side of the extra loss once
per segment (data/target_cache.GTGeomCache). `train.dist_impl fused_cull`
takes the region-culled loss kernel, its mask tiled at `train.chunk`
points (the other routes' kernels take no tile). `runtime.profile_dir`
(or the TAMF_PROFILE_DIR environment variable) writes a device trace of
train steps 11-20 there as Chrome-trace JSON (runtime/profiler.py); a run
that ends inside that span stops the trace and writes it too.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from ..core import diffusion as D
from ..core import mano as M
from ..data.collate import SegmentCollate
from ..data.target_cache import GTGeomCache
from ..models import losses as LL
from ..models.mdm_g import InteractionSegmentMDM, MDMConfig
from ..models.refine_r import stack_mano_models
from ..parallel import mesh
from ..parallel import train as PT
from ..runtime.ckpt import load_checkpoint, save_train_state
from ..runtime.profiler import DeviceTrace
from ..utils.seeding import setup_seed
from . import common, param

_logger = logging.getLogger(__name__)

PROG = "train_g"
PROFILE_SPAN = (10, 20)  # the trace starts before step 11 and stops after step 20


def build_model(reg, activation: str | None = None) -> InteractionSegmentMDM:
    """G from the `model.*` entries (model.remat and model.compute_dtype
    included). `activation` overrides model.activation (ported reference
    checkpoints need torch's exact-erf "gelu_exact")."""
    m = reg.select("model")
    return InteractionSegmentMDM(
        MDMConfig(
            input_dim=int(m.get("input_dim", 99)),
            obj_input_dim=int(m.get("obj_input_dim", 9)),
            hand_shape_dim=int(m.get("hand_shape_dim", 10)),
            obj_embed_dim=int(m.get("obj_embed_dim", 768)),
            latent_dim=int(m.get("latent_dim", 256)),
            ff_size=int(m.get("ff_size", 1024)),
            num_layers=int(m.get("num_layers", 8)),
            num_heads=int(m.get("num_heads", 4)),
            dropout=float(m.get("dropout", 0.1)),
            activation=activation or str(m.get("activation", "gelu")),
            cond_mask_prob=float(m.get("cond_mask_prob", 0.0)),
            remat=bool(m.get("remat", False)),
            compute_dtype=str(m.get("compute_dtype", "float32")),
        )
    )


@torch.no_grad()
def evaluate_g(sample_fn, model, mano_stack, assets, extra_cfg, loader, clip, device,
               generator: torch.Generator, max_batches: int = 0) -> dict[str, float]:
    """val/test pass (reference launch/train.py:577-656): sample G on held-out
    segments with `sample_fn` (parallel/train.make_g_sampler), then report
    the masked MSE against the GT and the geometric extra loss terms of the
    samples (batch sums, as in training), meaned over the batches of the
    global batch (every rank runs its stripe: mesh.reduce_batch_means).
    Each loader batch is this rank's rows [r*b, (r+1)*b) of a global batch,
    and its sampling noise is those rows of one draw over the global batch
    from `generator` (in the same state on every rank), drawn step by step:
    every global row gets its own noise, as one process on the global
    batch would draw it. max_batches=0 runs the whole split."""
    acc: dict[str, list] = {}
    for n, batch in enumerate(loader):
        if max_batches and n >= max_batches:
            break
        db = common.device_batch(common.attach_text_emb(batch, clip), device)
        sample = sample_fn(model, db, generator, global_batch=True)
        acc.setdefault("sample_mse", []).append(
            float(D.masked_l2(db["pose_repr"], sample, db["mask"]).mean())
        )
        _, terms = LL.interaction_segment_extra_loss(mano_stack, assets, extra_cfg, sample, db)
        for k, v in terms.items():
            acc.setdefault(k, []).append(float(v))
    return mesh.reduce_batch_means(acc, sums=[k for k in acc if k != "sample_mse"])


def _scalars(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v) for k, v in metrics.items() if v.ndim == 0}


def main(argv=None) -> PT.TrainState:
    reg, run_dir = common.boot(
        PROG,
        [
            param.reg_base_param,
            param.reg_profile_param,
            param.reg_mano_param,
            param.reg_model_param,
            lambda r: param.reg_train_param(r, 400),
            param.reg_diffusion_param,
            param.reg_loss_param,
            param.reg_clip_param,
        ],
        argv,
    )
    train_cfg = reg.select("train")
    runtime = reg.select("runtime")
    device = common.run_device(reg)
    seed = int(runtime.get("seed", 0))
    W, coordinator = mesh.world_size(), mesh.is_coordinator()
    _logger.info("device: %s", device)

    try:
        tdc = reg.select("train.data")
    except KeyError:
        tdc = {}
    mano_path = reg.select("mano").get("mano_path") or None
    mano_stack = stack_mano_models(
        M.get_mano_model(mano_path, "right"), M.get_mano_model(mano_path, "left"), device
    )
    train_ds = common.build_dataset(reg, "train")
    if bool(tdc.get("cache_gt_geom", False)):
        # every epoch reuses the GT-side signed chamfer (gt_o2h / gt_h2o),
        # precomputed on the run's device before the first step
        data_cfg = reg.select("data")
        train_ds = GTGeomCache(
            train_ds, mano_stack,
            SegmentCollate(max_nobj=int(data_cfg.get("max_nobj", 4)),
                           n_obj_points=int(data_cfg.get("n_obj_points", 2048))),
            cache_dir=tdc.get("gt_geom_cache_dir") or None,
        )
        common.precompute_cache(train_ds)
    train_loader = common.build_loader(reg, train_ds, "train")
    clip = common.build_clip(reg, device)

    torch.manual_seed(seed)  # weights: the same on every rank
    model = build_model(reg).to(device)
    setup_seed(seed)  # dropout and the cond mask: seed + rank
    dcfg = reg.select("diffusion")
    sched = D.tamf_schedule(
        int(dcfg.get("steps", 1000)), str(dcfg.get("noise_schedule", "cosine")),
        str(dcfg.get("timestep_respacing", "")),
    ).to(device)

    loss_yaml = train_cfg.get("loss", {})
    assets = LL.load_contact_assets(
        loss_yaml.get("vpe_path") or None, loss_yaml.get("c_weight_path") or None, device=device
    )
    extra_cfg = LL.ExtraLossConfig(
        coef_rec_joint=float(loss_yaml.get("coef_rec_joint_loss", 1.0)),
        coef_rec_vert=float(loss_yaml.get("coef_rec_vert_loss", 1.0)),
        coef_edge_len=float(loss_yaml.get("coef_edge_len_loss", 0.1)),
        coef_dist_h=float(loss_yaml.get("coef_dist_h_loss", 0.1)),
        coef_dist_o=float(loss_yaml.get("coef_dist_o_loss", 1.0)),
    )

    # optimizer: epoch milestones -> step milestones
    steps_per_epoch = len(train_loader)
    milestones = [int(m) * steps_per_epoch for m in train_cfg.get("scheduler_milestone", [])]
    optimizer = PT.make_optimizer(
        model.named_parameters(),
        base_lr=float(train_cfg.get("lr", 1e-4)),
        weight_decay=float(train_cfg.get("weight_decay", 0.0)),
        grad_clip=float(train_cfg.get("grad_clip", 0.1)),
        milestones_steps=milestones,
        gamma=float(train_cfg.get("scheduler_gamma", 0.5)),
    )
    state = PT.TrainState(model, optimizer)
    if train_cfg.get("reload_ckpt_model_filepath"):
        load_checkpoint(train_cfg["reload_ckpt_model_filepath"], state, strict=False)
        _logger.info("reloaded ckpt from %s at step %d", train_cfg["reload_ckpt_model_filepath"], state.step)

    step_fn = PT.make_g_train_step(
        sched, mano_stack, assets, extra_cfg, chunk=int(train_cfg.get("chunk", 2048)),
        dist_impl=str(train_cfg.get("dist_impl", "auto")),
    )
    from ..core.schedule_sampler import create_named_schedule_sampler

    sampler_name = str(train_cfg.get("schedule_sampler", "uniform"))
    resampler = (create_named_schedule_sampler(sampler_name, sched.num_timesteps)
                 if sampler_name != "uniform" else None)
    writer = common.metric_writer(run_dir)

    # the same on every rank: each draws over the global batch and keeps its rows
    generator = torch.Generator(device=device).manual_seed(seed)  # t and q_sample noise
    host_generator = torch.Generator().manual_seed(seed + 1)  # importance resampler
    val_freq = int(train_cfg.get("val_freq", 0) or 0)
    eval_loaders = common.build_eval_loaders(reg) if val_freq else {}
    eval_sampler = PT.make_g_sampler(sched)  # DDPM, as the JAX launcher's eval pass

    num_epoch = int(train_cfg.get("num_epoch", 400))
    record_freq = int(train_cfg.get("record_freq", 20))
    batch_size = int(train_cfg.get("batch_size", 64))
    profile_dir = (runtime.get("profile_dir") or os.environ.get("TAMF_PROFILE_DIR")) if coordinator else None
    profile = None
    global_step = 0
    try:
        for epoch_id in range(num_epoch):
            train_loader.set_epoch(epoch_id)
            t_epoch, epoch_start = time.time(), global_step
            last_metrics: dict[str, float] = {}
            metrics = {}
            for batch in train_loader:
                db = common.device_batch(common.attach_text_emb(batch, clip), device)
                if resampler is not None:
                    t, w = resampler.sample(W * db["pose_repr"].shape[0], generator=host_generator, device=device)
                    db = dict(db, t=mesh.shard_rows(t), t_weights=mesh.shard_rows(w))
                if profile_dir and global_step == PROFILE_SPAN[0]:
                    profile = DeviceTrace(profile_dir, device).start()
                metrics = step_fn(state, db, generator=generator)
                global_step += 1
                if profile is not None and global_step == PROFILE_SPAN[1]:
                    _logger.info("profiler trace (steps %d-%d) -> %s", PROFILE_SPAN[0] + 1, PROFILE_SPAN[1],
                                 profile.stop())
                    profile = None
                if resampler is not None:
                    resampler.update_with_losses(metrics["per_sample_t"], metrics["per_sample_mse"])
                if global_step % 50 == 0:
                    last_metrics = _scalars(metrics)
                    writer.add_scalars(last_metrics, global_step)
            seconds, rate = common.epoch_rate(global_step - epoch_start, W * batch_size, t_epoch, device)
            if not last_metrics and metrics:
                last_metrics = _scalars(metrics)
            _logger.info(
                "train epoch %04d conclude | loss: %f | %.1fs | %.1f samples/s",
                epoch_id, last_metrics.get("loss", float("nan")), seconds, rate,
            )
            if coordinator and run_dir.commit and (epoch_id % record_freq == 0 or epoch_id == num_epoch - 1):
                path = save_train_state(run_dir.sub("save"), epoch_id, state)
                _logger.info("saved %s", path)
            if val_freq and (epoch_id == 0 or (epoch_id + 1) % val_freq == 0 or epoch_id == num_epoch - 1):
                for split, loader in eval_loaders.items():
                    terms = evaluate_g(
                        eval_sampler, model, mano_stack, assets, extra_cfg, loader, clip, device, generator,
                        max_batches=int(train_cfg.get("eval_max_batches", 0) or 0),
                    )
                    if not coordinator:
                        continue
                    _logger.info("%s epoch %04d sample eval | %s", split, epoch_id,
                                 " | ".join(f"{k}: {v:f}" for k, v in sorted(terms.items())))
                    for k, v in terms.items():
                        writer.add_scalar(f"{split}/{k}", v, global_step)
    finally:
        if profile is not None:  # the run ended inside the span
            _logger.info("profiler trace (steps %d-%d) -> %s", PROFILE_SPAN[0] + 1, global_step, profile.stop())
    writer.close()
    return state


if __name__ == "__main__":
    main()
