"""R training: the program's train step (parallel/train.make_r_train_step,
`h2o_backend` from the traffic) on a pool of distinct batches whose
target-h2o cache (data/target_cache.TargetH2OCache) is filled in set-up,
as train_r fills it; the network's input is the Gaussian-perturbed GT.
Each step moves its batch to the card with launch/common.device_batch,
steps sent without a per-step synchronise.

Set-up and the check follow entries/train_g.py: three checked steps on
distinct batches with dropout seeded from the run's seed, one warm step,
the window, then the reference's three steps (which compute the target
h2o themselves) from the same weights, batches and seeds.
"""

from __future__ import annotations

import torch

from ..lib import compare, seeds, segments, work
from . import common


def _groups(ctx):
    tr, cfg = ctx.traffic, ctx.cfg
    bs = int(cfg["train"]["batch_size"])
    segs = segments.make_segments(ctx.seed, "pool", bs * int(tr["pool_batches"]), common.data_params(cfg, tr),
                                  group=bs)
    sigma = tuple(cfg["train"]["gaussian_perturb_range"])
    groups = common.host_batches(segs, bs)
    return [segments.perturb(g, ctx.seed, f"perturb{i}", sigma) for i, g in enumerate(groups)]


def run(ctx: common.Context) -> dict:
    from oakink2_tamf_tpu_torch.data.target_cache import TargetH2OCache
    from oakink2_tamf_tpu_torch.launch.common import device_batch
    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.parallel import train as PT

    cfg, dev, tc = ctx.cfg, ctx.device, ctx.cfg["train"]
    dcfg = cfg["data"]
    bs = int(tc["batch_size"])
    mano = common.program_mano(dev)
    model = common.program_r(cfg, ctx.seed, dev)
    opt = PT.make_optimizer(model.named_parameters(), base_lr=tc["lr"], weight_decay=tc["weight_decay"],
                            grad_clip=tc["grad_clip"])
    state = PT.TrainState(model, opt)
    step_fn = PT.make_r_train_step(mano, common.program_assets(dev), LL.RefineLossConfig(**tc["loss"]),
                                   backend=ctx.traffic["h2o_backend"], chunk=int(tc["chunk"]))
    ctx.mark("model, optimizer and step")
    groups = _groups(ctx)
    ctx.mark("segments")
    collate = segments.Collate(int(dcfg["max_nobj"]), int(dcfg["n_obj_points"]))
    base = [s for g in groups for s in g]
    cache = TargetH2OCache(base, mano, collate)
    cache.precompute()
    ctx.mark("target-h2o cache")
    pool = [collate([cache[i] for i in range(b * bs, (b + 1) * bs)]) for b in range(len(groups))]
    ctx.mark("collate")

    losses = []
    named = dict(model.named_parameters())
    for k in range(3):
        seeds.seed_global(dev, ctx.seed, f"dropout{k}")
        losses.append(step_fn(state, device_batch(pool[k], dev))["loss"])
        if k == 0:
            g1 = compare.first_gradients(opt.adamw, named)
    p3 = common.named_clone(model)
    ctx.mark("three checked steps")
    step_fn(state, device_batch(pool[3 % len(pool)], dev))
    losses = [float(v) for v in losses]
    ctx.mark("warm step")

    def step(i):
        step_fn(state, device_batch(pool[(4 + i) % len(pool)], dev))

    n, m = common.drive(ctx, step)
    ctx.mark("window")
    timed = [pool[(4 + i) % len(pool)] for i in range(n)]
    del state, model, opt, step_fn, cache, base
    common.free_device(dev)

    prog = {"losses": losses, "g1": g1, "p3": p3}
    ref = reference(ctx, groups)
    ctx.mark("reference")
    checks = compare.train_checks(prog, ref, ctx.limits, ctx.notes)
    readings = {}
    if ctx.control:
        readings = common.control_readings(
            lambda **kw: reference(ctx, groups, **kw), ref,
            lambda got, r: compare.train_checks(got, r, ctx.limits), [("half_batch", {"half": True})])
    return {
        "attempted": n, "failed": 0,
        "e2e": {"train_samples_per_s": bs * n / ctx.window.seconds},
        "checks": checks, "readings": readings,
        "layer": {"work_flops": sum(step_flops(cfg, b) for b in timed)},
        "traced": {"steps": m},
    }


def step_flops(cfg: dict, batch: dict) -> float:
    """One R train step: the net forward and backward; MANO of the target, of
    the sample and (forward and backward) of the refined pose; the sample's
    and the refined pose's searches (the target's h2o is cached)."""
    bs, L = batch["mask"].shape
    live = work.live_frames(batch["mask"], batch["obj_mask"])
    return (3 * bs * work.r_forward(cfg["r_model"], L, int(cfg["data"]["max_nobj"]))
            + 5 * bs * L * work.mano_frame() + 2 * work.search(live, int(cfg["data"]["n_obj_points"])))


def reference(ctx: common.Context, groups, half: bool = False) -> dict:
    """The reference's first three steps on the same batches and seeds (on
    the first half of each batch's rows with `half`)."""
    from ..lib import assets as A
    from ..reference import steps as RS

    cfg, dev, tc = ctx.cfg, ctx.device, ctx.cfg["train"]
    model = common.reference_r(cfg, ctx.seed, dev)
    opt = RS.Optimizer(model.named_parameters(), lr=tc["lr"], grad_clip=tc["grad_clip"],
                       weight_decay=tc["weight_decay"])
    mano, faces = A.reference_mano(dev)
    assets = A.reference_assets(dev)
    named = dict(model.named_parameters())
    p0 = common.named_clone(model)
    losses = []
    for k in range(3):
        batch = segments.collate(groups[k], int(cfg["data"]["max_nobj"]))
        batch = segments.to_device(common.half_batch(batch) if half else batch, dev)
        seeds.seed_global(dev, ctx.seed, f"dropout{k}")
        losses.append(RS.r_step(model, opt, mano, faces, assets, tc["loss"], batch))
        if k == 0:
            g1 = compare.first_gradients(opt.adamw, named)
    return {"losses": losses, "g1": g1, "p0": p0, "p3": common.named_clone(model)}
