"""Train MF-MDM R, the refiner (port of oakink2_tamf_tpu/launch/train_r.py;
the reference's launch/train_refine.py workflow) on one device.

    python -m oakink2_tamf_tpu_torch.launch.train_r --cfg config/arch_refine.yml \
        --data.synthetic true [--runtime.device cpu] [--commit]

Training data: ConcatDataset[GeneratedPoseReprSampleAdaptor(G sample dirs),
GaussianPerturbSampleAdaptor(sigma in train.data.gaussian_perturb_range)]
over the base dataset, which the target-h2o cache wraps
(train.data.cache_target_h2o, on by default) and precomputes on the run's
device before the first step. Each step differentiates the refined branch
only: R, MANO of its output and the h2o kernels (parallel/train.py).

The YAMLs are the JAX package's. The device is `runtime.device` ("cuda" by
default; without a GPU the run raises unless told "cpu"); `train.h2o_backend`
routes the h2o searches ("auto", "cull", "exact", or the cluster-pruned
opt-in "cluster"; "xla" raises). Each val/test pass runs the JAX launcher's
cluster-exactness certificate on its first batch (`make_overflow_probe`,
`report_cluster_overflow`): INFO when the sample hand's cluster search was
provably exact (always so off the cluster route), WARNING with the count of
overflowed tiles otherwise, and the `{split}/h2o_cluster_overflow` scalar.
Not ported: the real-data segments (`data.synthetic` must be true).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .._device import resolve_device
from ..core import mano as M
from ..data.adaptors import ConcatDataset, GaussianPerturbSampleAdaptor, GeneratedPoseReprSampleAdaptor
from ..data.collate import SegmentCollate
from ..data.target_cache import TargetH2OCache
from ..models import losses as LL
from ..models.refine_r import (
    RefineConfig,
    SegmentRefineNet,
    batch_recover_mano,
    multi_object_h2o_overflow,
    refine_forward,
    stack_mano_models,
)
from ..parallel import train as PT
from ..runtime.ckpt import load_checkpoint, save_train_state
from ..runtime.logging import MetricWriter
from ..runtime.profiler import StepTimer
from . import common, param

_logger = logging.getLogger(__name__)

PROG = "train_r"


def build_refine_net(reg, activation: str | None = None) -> SegmentRefineNet:
    """R from the `model.*` entries. `activation` overrides model.activation
    (ported reference checkpoints need torch's exact-erf "gelu_exact")."""
    m = reg.select("model")
    if bool(m.get("remat", False)) or str(m.get("compute_dtype", "float32")) != "float32":
        raise NotImplementedError("the port trains R in float32 without remat "
                                  "(model.remat false, model.compute_dtype float32)")
    return SegmentRefineNet(
        RefineConfig(
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
        )
    )


def _train_data_cfg(reg) -> dict:
    try:
        return reg.select("train.data")
    except KeyError:
        return {}


def build_r_train_dataset(reg, mano_stack=None):
    """(dataset, target_h2o cache or None). With mano_stack given and
    train.data.cache_target_h2o on, the base dataset is wrapped so both
    adaptor views share one cache."""
    base = common.build_dataset(reg, "train")
    tdc = _train_data_cfg(reg)
    sample_dirs = tdc.get("pose_repr_sample_dir_list") or []
    sigma_range = tdc.get("gaussian_perturb_range") or [0.02, 0.1]

    cache = None
    if mano_stack is not None and bool(tdc.get("cache_target_h2o", True)):
        data_cfg = reg.select("data")
        collate = SegmentCollate(
            max_nobj=int(data_cfg.get("max_nobj", 4)),
            n_obj_points=int(data_cfg.get("n_obj_points", 2048)),
        )
        cache = TargetH2OCache(base, mano_stack, collate,
                               cache_dir=tdc.get("target_h2o_cache_dir") or None)
        base = cache

    parts = []
    if sample_dirs:
        parts.append(GeneratedPoseReprSampleAdaptor(base, sample_dirs))
    parts.append(GaussianPerturbSampleAdaptor(base, sigma_range, seed=int(reg.select("runtime").get("seed", 0))))
    ds = ConcatDataset(parts) if len(parts) > 1 else parts[0]
    return ds, cache


def refine_forward_eval(net, mano_stack, batch, backend: str = "auto"):
    """R's deterministic forward with the target branch: dropout off
    (net.eval()), mask-padded frames culled as in training."""
    net.eval()
    return refine_forward(net, mano_stack, batch, backend=backend, loss_frame_mask=batch["mask"])


def make_overflow_probe(mano_stack, *, backend: str = "auto"):
    """Batch -> total cluster-overflow count (a 0-d int32 tensor) of the h2o
    search the refine pass runs on the sample hand, R's live input (JAX
    launch/train_r.py:286). Zero proves the cluster route's distances
    exact; it is zero off the cluster route."""

    @torch.no_grad()
    def probe(b) -> torch.Tensor:
        verts, _, _ = batch_recover_mano(mano_stack, b["sample_pose_repr"], b["shape"], b["hand_side"])
        ovf = multi_object_h2o_overflow(verts, b["obj_traj"], b["obj_points"], b["obj_mask"],
                                        x_perm=mano_stack.template_perm, backend=backend)
        return ovf.sum()

    return probe


def report_cluster_overflow(ovf_fn, batch, split: str, epoch_id: int, writer, step: int) -> int:
    """Run the overflow probe on one val batch; INFO at zero, WARNING above
    (the h2o distances were overestimated: retune k_cells or route
    backend='exact'), and the `{split}/h2o_cluster_overflow` scalar. Returns
    the count (JAX launch/train_r.py:309)."""
    count = int(ovf_fn(batch))
    if count > 0:
        _logger.warning(
            "%s epoch %04d: cluster NN overflow on val batch — %d x-tiles "
            "exceeded the candidate budget; h2o distances in this regime are "
            "OVERESTIMATED. Retune ops/chamfer_cluster k_cells or route "
            "backend='exact'.",
            split, epoch_id, count,
        )
    else:
        _logger.info("%s epoch %04d: cluster-exactness certificate ok (0 overflow)", split, epoch_id)
    if writer is not None:
        writer.add_scalar(f"{split}/h2o_cluster_overflow", float(count), step)
    return count


@torch.no_grad()
def evaluate_r(net, mano_stack, assets, loss_cfg, loader, device, backend: str = "auto",
               max_batches: int = 0, on_first_batch=None) -> dict[str, float]:
    """val/test pass (reference train_refine.py val passes): the refine loss
    and its terms of the deterministic forward, meaned over the batches;
    max_batches=0 runs the whole split. `on_first_batch(device_batch)` runs
    once, on the first batch (the launcher's exactness certificate)."""
    was_training = net.training
    acc: dict[str, list] = {}
    for n, batch in enumerate(loader):
        if max_batches and n >= max_batches:
            break
        db = common.device_batch(batch, device)
        if n == 0 and on_first_batch is not None:
            on_first_batch(db)
        _, terms = LL.segment_refine_loss(assets, loss_cfg, refine_forward_eval(net, mano_stack, db, backend), db)
        for k, v in terms.items():
            acc.setdefault(k, []).append(float(v))
    net.train(was_training)
    return {k: float(np.mean(v)) for k, v in acc.items()}


def main(argv=None) -> PT.TrainState:
    reg, run_dir = common.boot(
        PROG,
        [
            param.reg_base_param,
            param.reg_mano_param,
            param.reg_model_param,
            lambda r: param.reg_train_param(r, 400),
            param.reg_loss_param,
            param.reg_refine_sample_param,
        ],
        argv,
    )
    train_cfg = reg.select("train")
    runtime = reg.select("runtime")
    device = resolve_device(runtime.get("device") or "cuda")
    seed = int(runtime.get("seed", 0))
    backend = str(train_cfg.get("h2o_backend", "auto"))
    _logger.info("device: %s", device)

    mano_path = reg.select("mano").get("mano_path") or None
    mano_stack = stack_mano_models(
        M.get_mano_model(mano_path, "right"), M.get_mano_model(mano_path, "left"), device
    )
    dataset, t_cache = build_r_train_dataset(reg, mano_stack)
    loader = common.build_loader(reg, dataset, "train")
    if t_cache is not None:
        # on the run's device, before any loader thread could miss
        t_cache.precompute()

    torch.manual_seed(seed)  # weights and dropout
    net = build_refine_net(reg).to(device)
    loss_yaml = train_cfg.get("loss", {})
    assets = LL.load_contact_assets(
        loss_yaml.get("vpe_path") or None, loss_yaml.get("c_weight_path") or None, device=device
    )
    loss_cfg = LL.RefineLossConfig(
        coef_rec_joint=float(loss_yaml.get("coef_rec_joint_loss", 1.0)),
        coef_rec_vert=float(loss_yaml.get("coef_rec_vert_loss", 1.0)),
        coef_dist_h=float(loss_yaml.get("coef_dist_h_loss", 0.1)),
    )

    steps_per_epoch = len(loader)
    milestones = [int(m) * steps_per_epoch for m in train_cfg.get("scheduler_milestone", [])]
    optimizer = PT.make_optimizer(
        net.named_parameters(),
        base_lr=float(train_cfg.get("lr", 1e-4)),
        weight_decay=float(train_cfg.get("weight_decay", 0.0)),
        grad_clip=float(train_cfg.get("grad_clip", 0.1)),
        milestones_steps=milestones,
        gamma=float(train_cfg.get("scheduler_gamma", 0.5)),
    )
    state = PT.TrainState(net, optimizer)
    if train_cfg.get("reload_ckpt_model_filepath"):
        load_checkpoint(train_cfg["reload_ckpt_model_filepath"], state, strict=False)
        _logger.info("reloaded ckpt from %s at step %d", train_cfg["reload_ckpt_model_filepath"], state.step)

    step_fn = PT.make_r_train_step(mano_stack, assets, loss_cfg, backend=backend)
    ovf_fn = make_overflow_probe(mano_stack, backend=backend)
    writer = MetricWriter(run_dir.sub("summary") if run_dir.commit else None, enabled=run_dir.commit)

    def wrap_eval(split, base):
        try:
            dirs = reg.select(f"{split}.data").get("pose_repr_sample_dir_list") or []
        except KeyError:
            dirs = []
        if dirs:
            return GeneratedPoseReprSampleAdaptor(base, dirs)
        return GaussianPerturbSampleAdaptor(base, (0.02, 0.1), seed=1)

    val_freq = int(train_cfg.get("val_freq", 0) or 0)
    eval_loaders = common.build_eval_loaders(reg, wrap=wrap_eval) if val_freq else {}

    num_epoch = int(train_cfg.get("num_epoch", 400))
    record_freq = int(train_cfg.get("record_freq", 20))
    batch_size = int(train_cfg.get("batch_size", 64))
    timer = StepTimer()
    global_step = 0
    for epoch_id in range(num_epoch):
        loader.set_epoch(epoch_id)
        t_epoch = time.time()
        metrics: dict[str, torch.Tensor] = {}
        for batch in loader:
            metrics = step_fn(state, common.device_batch(batch, device))
            global_step += 1
            timer.tick()
            if global_step % 50 == 0:
                writer.add_scalars({k: float(v) for k, v in metrics.items()}, global_step)
        _logger.info(
            "train epoch %04d conclude | loss: %f | %.1fs | %.1f samples/s",
            epoch_id, float(metrics["loss"]) if metrics else float("nan"), time.time() - t_epoch,
            timer.throughput(batch_size),
        )
        if run_dir.commit and (epoch_id % record_freq == 0 or epoch_id == num_epoch - 1):
            path = save_train_state(run_dir.sub("save"), epoch_id, state)
            _logger.info("saved %s", path)
        if val_freq and (epoch_id == 0 or (epoch_id + 1) % val_freq == 0 or epoch_id == num_epoch - 1):
            for split, eval_loader in eval_loaders.items():
                def certify(db, split=split):
                    report_cluster_overflow(ovf_fn, db, split, epoch_id, writer, global_step)

                terms = evaluate_r(net, mano_stack, assets, loss_cfg, eval_loader, device, backend,
                                   max_batches=int(train_cfg.get("eval_max_batches", 0) or 0),
                                   on_first_batch=certify)
                _logger.info("%s epoch %04d refine eval | %s", split, epoch_id,
                             " | ".join(f"{k}: {v:f}" for k, v in sorted(terms.items())))
                for k, v in terms.items():
                    writer.add_scalar(f"{split}/{k}", v, global_step)
    writer.close()
    return state


if __name__ == "__main__":
    main()
