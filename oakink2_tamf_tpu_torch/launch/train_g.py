"""Train MF-MDM G (port of oakink2_tamf_tpu/launch/train_g.py; the reference's
launch/train.py workflow) on one device.

    python -m oakink2_tamf_tpu_torch.launch.train_g --cfg config/arch_mdm_l.yml \
        --cfg config/loss_param.yml --data.synthetic true [--runtime.device cpu] [--commit]

The YAMLs are the JAX package's. The device is `runtime.device` ("cuda" by
default; without a GPU the run raises unless told "cpu").
`train.data.cache_gt_geom` precomputes the GT side of the extra loss once
per segment (data/target_cache.GTGeomCache). Not ported yet: the real-data
segments (`data.synthetic` must be true), the profiler trace hook, and the
`train.chunk` tile (the CUDA kernels need none).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .._device import resolve_device
from ..core import diffusion as D
from ..core import mano as M
from ..data.collate import SegmentCollate
from ..data.target_cache import GTGeomCache
from ..models import losses as LL
from ..models.mdm_g import InteractionSegmentMDM, MDMConfig
from ..models.refine_r import stack_mano_models
from ..parallel import train as PT
from ..runtime.ckpt import load_checkpoint, save_train_state
from ..runtime.logging import MetricWriter
from ..runtime.profiler import StepTimer
from . import common, param

_logger = logging.getLogger(__name__)

PROG = "train_g"


def build_model(reg, activation: str | None = None) -> InteractionSegmentMDM:
    """G from the `model.*` entries. `activation` overrides model.activation
    (ported reference checkpoints need torch's exact-erf "gelu_exact")."""
    m = reg.select("model")
    if bool(m.get("remat", False)) or str(m.get("compute_dtype", "float32")) != "float32":
        raise NotImplementedError("the port trains G in float32 without remat "
                                  "(model.remat false, model.compute_dtype float32)")
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
        )
    )


@torch.no_grad()
def evaluate_g(model, sched, mano_stack, assets, extra_cfg, loader, clip, device,
               generator: torch.Generator, max_batches: int = 0) -> dict[str, float]:
    """val/test pass (reference launch/train.py:577-656): sample G on held-out
    segments with the DDPM chain, then report the masked MSE against the GT
    and the geometric extra loss terms of the samples. max_batches=0 runs
    the whole split."""
    was_training = model.training
    model.eval()
    acc: dict[str, list] = {}
    for n, batch in enumerate(loader):
        if max_batches and n >= max_batches:
            break
        db = common.device_batch(common.attach_text_emb(batch, clip), device)
        cond = PT.g_cond_from_batch(db)
        sample = D.p_sample_loop(lambda x, t: model(x, t, cond), sched, tuple(db["pose_repr"].shape),
                                 device=device, generator=generator)
        acc.setdefault("sample_mse", []).append(
            float(D.masked_l2(db["pose_repr"], sample, db["mask"]).mean())
        )
        _, terms = LL.interaction_segment_extra_loss(mano_stack, assets, extra_cfg, sample, db)
        for k, v in terms.items():
            acc.setdefault(k, []).append(float(v))
    model.train(was_training)
    return {k: float(np.mean(v)) for k, v in acc.items()}


def _scalars(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(v) for k, v in metrics.items() if v.ndim == 0}


def main(argv=None) -> PT.TrainState:
    reg, run_dir = common.boot(
        PROG,
        [
            param.reg_base_param,
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
    device = resolve_device(runtime.get("device") or "cuda")
    seed = int(runtime.get("seed", 0))
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
        train_ds.precompute()
    train_loader = common.build_loader(reg, train_ds, "train")
    clip = common.build_clip(reg, device)

    torch.manual_seed(seed)  # weights and dropout
    model = build_model(reg).to(device)
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
        sched, mano_stack, assets, extra_cfg, dist_impl=str(train_cfg.get("dist_impl", "auto"))
    )
    from ..core.schedule_sampler import create_named_schedule_sampler

    sampler_name = str(train_cfg.get("schedule_sampler", "uniform"))
    resampler = (create_named_schedule_sampler(sampler_name, sched.num_timesteps)
                 if sampler_name != "uniform" else None)
    writer = MetricWriter(run_dir.sub("summary") if run_dir.commit else None, enabled=run_dir.commit)

    generator = torch.Generator(device=device).manual_seed(seed)  # t and q_sample noise
    host_generator = torch.Generator().manual_seed(seed + 1)  # importance resampler
    val_freq = int(train_cfg.get("val_freq", 0) or 0)
    eval_loaders = common.build_eval_loaders(reg) if val_freq else {}

    num_epoch = int(train_cfg.get("num_epoch", 400))
    record_freq = int(train_cfg.get("record_freq", 20))
    batch_size = int(train_cfg.get("batch_size", 64))
    timer = StepTimer()
    global_step = 0
    for epoch_id in range(num_epoch):
        train_loader.set_epoch(epoch_id)
        t_epoch = time.time()
        last_metrics: dict[str, float] = {}
        metrics = {}
        for batch in train_loader:
            db = common.device_batch(common.attach_text_emb(batch, clip), device)
            if resampler is not None:
                t, w = resampler.sample(db["pose_repr"].shape[0], generator=host_generator, device=device)
                db = dict(db, t=t, t_weights=w)
            metrics = step_fn(state, db, generator=generator)
            global_step += 1
            timer.tick()
            if resampler is not None:
                resampler.update_with_losses(metrics["per_sample_t"], metrics["per_sample_mse"])
            if global_step % 50 == 0:
                last_metrics = _scalars(metrics)
                writer.add_scalars(last_metrics, global_step)
        if not last_metrics and metrics:
            last_metrics = _scalars(metrics)
        _logger.info(
            "train epoch %04d conclude | loss: %f | %.1fs | %.1f samples/s",
            epoch_id, last_metrics.get("loss", float("nan")), time.time() - t_epoch,
            timer.throughput(batch_size),
        )
        if run_dir.commit and (epoch_id % record_freq == 0 or epoch_id == num_epoch - 1):
            path = save_train_state(run_dir.sub("save"), epoch_id, state)
            _logger.info("saved %s", path)
        if val_freq and (epoch_id == 0 or (epoch_id + 1) % val_freq == 0 or epoch_id == num_epoch - 1):
            for split, loader in eval_loaders.items():
                terms = evaluate_g(
                    model, sched, mano_stack, assets, extra_cfg, loader, clip, device, generator,
                    max_batches=int(train_cfg.get("eval_max_batches", 0) or 0),
                )
                _logger.info("%s epoch %04d sample eval | %s", split, epoch_id,
                             " | ".join(f"{k}: {v:f}" for k, v in sorted(terms.items())))
                for k, v in terms.items():
                    writer.add_scalar(f"{split}/{k}", v, global_step)
    writer.close()
    return state


if __name__ == "__main__":
    main()
