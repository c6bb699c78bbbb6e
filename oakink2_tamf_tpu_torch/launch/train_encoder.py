"""Train the FID SegmentEncoder (port of oakink2_tamf_tpu/launch/train_encoder.py;
the reference's launch/train_encoder.py workflow) on one device, or one
process per device under torchrun (each rank on its stripe, every step the
global batch's; rank 0 writes checkpoints and summaries and logs the eval
pass, which every rank runs over its stripe).

    python -m oakink2_tamf_tpu_torch.launch.train_encoder --cfg config/arch_encoder.yml \
        --train.cache_dict_filepath <cache_dict.pkl> --data.obj_embedding_prefix <dir> \
        [--runtime.device cpu] [--commit]

Data: ActionRecognitionAdapter(ConcatDataset[IdentitySampleAdaptor,
GeneratedPoseReprSampleAdaptor (when train.data.pose_repr_sample_dir_list
is set), GaussianPerturbSampleAdaptor(sigma in (0.02, 0.1), seed 0)]) over
the train split (ref :351-358); the sampled pose_repr replaces the GT input
(ref :521-523). Loss: cross-entropy over the actions, with the accuracy.
The val/test passes (train.val_freq, capped at train.eval_max_batches
batches) report CE and accuracy on the GT (identity) view. The device is
`runtime.device` ("cuda" by default; without a GPU the run raises unless
told "cpu"). Checkpoints, with --commit: save/model_{epoch:04d}.pt every
train.record_freq epochs and at the last.
"""

from __future__ import annotations

import logging
import time

import torch

from ..data.adaptors import (
    ActionRecognitionAdapter,
    ConcatDataset,
    GaussianPerturbSampleAdaptor,
    GeneratedPoseReprSampleAdaptor,
    IdentitySampleAdaptor,
)
from ..models import losses as LL
from ..models.encoder import COND_KEYS, EncoderConfig, SegmentEncoder
from ..parallel import mesh
from ..parallel import train as PT
from ..runtime.ckpt import load_checkpoint, save_train_state
from ..utils.seeding import setup_seed
from . import common, param

_logger = logging.getLogger(__name__)

PROG = "train_encoder"


def build_encoder(reg, activation: str | None = None) -> SegmentEncoder:
    """The encoder from the `model.*` entries. `activation` overrides
    model.activation (a reference checkpoint runs under "gelu_exact":
    common.activation_for_checkpoint)."""
    m = reg.select("model")
    return SegmentEncoder(
        EncoderConfig(
            output_dim=int(m.get("output_dim", 70)),
            input_dim=int(m.get("input_dim", 99)),
            obj_input_dim=int(m.get("obj_input_dim", 9)),
            hand_shape_dim=int(m.get("hand_shape_dim", 10)),
            obj_embed_dim=int(m.get("obj_embed_dim", 768)),
            latent_dim=int(m.get("latent_dim", 64)),
            ff_size=int(m.get("ff_size", 128)),
            num_layers=int(m.get("num_layers", 2)),
            num_heads=int(m.get("num_heads", 4)),
            dropout=float(m.get("dropout", 0.1)),
            activation=activation or str(m.get("activation", "gelu")),
        )
    )


@torch.no_grad()
def evaluate_encoder(model, loader, device, max_batches: int = 0) -> dict[str, float]:
    """CE and accuracy of the deterministic forward (dropout off) on the GT
    pose_repr, meaned over the batches of the global batch (every rank runs
    its stripe); max_batches=0 runs the whole split."""
    was_training = model.training
    model.eval()
    acc: dict[str, list] = {}
    for n, batch in enumerate(loader):
        if max_batches and n >= max_batches:
            break
        db = common.device_batch(batch, device)
        _, terms = LL.segment_encoder_loss(model(db["pose_repr"], {k: db[k] for k in COND_KEYS}),
                                           db["action_label_id"])
        for k, v in terms.items():
            acc.setdefault(k, []).append(float(v))
    model.train(was_training)
    return mesh.reduce_batch_means(acc)


def main(argv=None, toolkit=None) -> PT.TrainState:
    """`toolkit` (oakink2_toolkit's interface) goes to common.build_dataset."""
    reg, run_dir = common.boot(
        PROG,
        [
            param.reg_base_param,
            param.reg_model_param,
            lambda r: param.reg_train_param(r, 400),
            param.reg_refine_sample_param,
        ],
        argv,
    )
    train_cfg = reg.select("train")
    runtime = reg.select("runtime")
    device = common.run_device(reg)
    seed = int(runtime.get("seed", 0))
    W, coordinator = mesh.world_size(), mesh.is_coordinator()
    _logger.info("device: %s", device)

    base = common.build_dataset(reg, "train", toolkit=toolkit)
    try:
        sample_dirs = reg.select("train.data").get("pose_repr_sample_dir_list") or []
    except KeyError:
        sample_dirs = []
    parts = [IdentitySampleAdaptor(base)]
    if sample_dirs:
        parts.append(GeneratedPoseReprSampleAdaptor(base, sample_dirs))
    parts.append(GaussianPerturbSampleAdaptor(base, (0.02, 0.1), seed=0))
    loader = common.build_loader(reg, ActionRecognitionAdapter(ConcatDataset(parts)), "train")

    torch.manual_seed(seed)  # weights: the same on every rank
    model = build_encoder(reg).to(device)
    setup_seed(seed)  # dropout: seed + rank
    steps_per_epoch = len(loader)
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

    step_fn = PT.make_encoder_train_step()
    writer = common.metric_writer(run_dir)
    val_freq = int(train_cfg.get("val_freq", 0) or 0)
    eval_loaders = {}
    if val_freq:
        eval_loaders = common.build_eval_loaders(
            reg, wrap=lambda _s, ds: ActionRecognitionAdapter(IdentitySampleAdaptor(ds)),
            toolkit=toolkit,
        )

    num_epoch = int(train_cfg.get("num_epoch", 400))
    record_freq = int(train_cfg.get("record_freq", 20))
    batch_size = int(train_cfg.get("batch_size", 64))
    global_step = 0
    for epoch_id in range(num_epoch):
        loader.set_epoch(epoch_id)
        t_epoch, epoch_start = time.time(), global_step
        metrics: dict[str, torch.Tensor] = {}
        for batch in loader:
            metrics = step_fn(state, common.device_batch(batch, device))
            global_step += 1
            if global_step % 50 == 0:
                writer.add_scalars({k: float(v) for k, v in metrics.items()}, global_step)
        seconds, rate = common.epoch_rate(global_step - epoch_start, W * batch_size, t_epoch, device)
        _logger.info(
            "train epoch %04d | ce %.4f acc %.3f | %.1fs | %.1f samples/s", epoch_id,
            float(metrics["ce"]) if metrics else float("nan"),
            float(metrics["acc"]) if metrics else float("nan"), seconds, rate,
        )
        if coordinator and run_dir.commit and (epoch_id % record_freq == 0 or epoch_id == num_epoch - 1):
            path = save_train_state(run_dir.sub("save"), epoch_id, state)
            _logger.info("saved %s", path)
        if val_freq and (epoch_id == 0 or (epoch_id + 1) % val_freq == 0 or epoch_id == num_epoch - 1):
            for split, eval_loader in eval_loaders.items():
                means = evaluate_encoder(model, eval_loader, device,
                                         max_batches=int(train_cfg.get("eval_max_batches", 0) or 0))
                if means and coordinator:
                    _logger.info("%s epoch %04d | ce %.4f acc %.3f", split, epoch_id,
                                 means.get("ce", float("nan")), means.get("acc", float("nan")))
                for k, v in means.items():
                    writer.add_scalar(f"{split}/{k}", v, global_step)
    writer.close()
    return state


if __name__ == "__main__":
    main()
