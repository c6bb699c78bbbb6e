"""G training: the program's train step (parallel/train.make_g_train_step) on
a pool of distinct global batches, each moved to the card per step with
launch/common.device_batch, steps sent without a per-step synchronise.

Set-up builds one train state, drives it through its first three steps on
three distinct batches with seeded draws (the step generator for the
timesteps and the q_sample noise, torch's global generator for dropout),
keeps the first gradient and the parameters after step 3, warms one more
step, and hands the same state to the window. After the window the program
is freed and the reference follows the same three steps from the same
weights, batches and seeds.

On W chips each rank drives the step under the live process group with
rows [r*b, (r+1)*b) of every global batch of W*b rows and its own dropout
seeds: b is the configuration's batch_size, which the port's loader reads
per rank, and each global batch is in one random order, so the ranks' rows
differ in length as the loader's shuffled deal makes them. The step
generator is in the same state on every rank, so the timesteps and the
noise are one draw over the global batch. The reference runs the global
step alone, block by block (reference/steps.g_step), on every rank's card,
and each rank compares its own state with it. The rate counts the global batch; the work counted for
`mfu.train` is the group's, the kernels' least times this rank's rows.
"""

from __future__ import annotations

import torch

from ..lib import compare, seeds, segments, work
from . import common


def _extra_cfg(loss: dict):
    from oakink2_tamf_tpu_torch.models import losses as LL

    return LL.ExtraLossConfig(**loss)


def _pool(ctx, bs: int):
    """The pool's global batches of `bs` segments, each holding the same
    sizes in its own order, and the text table."""
    tr, cfg = ctx.traffic, ctx.cfg
    segs = segments.make_segments(ctx.seed, "pool", bs * int(tr["pool_batches"]), common.data_params(cfg, tr),
                                  group=bs)
    table = segments.text_table(ctx.seed, int(tr.get("n_prompts", 7)))
    for s in segs:
        s["text_emb"] = table[segments.prompt_id(s["text"])]
    return common.host_batches(segs, bs), table


def run(ctx: common.Context) -> dict:
    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.launch.common import device_batch
    from oakink2_tamf_tpu_torch.ops import chamfer_loss, chamfer_signed
    from oakink2_tamf_tpu_torch.parallel import train as PT

    cfg, dev, tc = ctx.cfg, ctx.device, ctx.cfg["train"]
    dcfg = cfg["data"]
    mano = common.program_mano(dev)
    model = common.program_g(cfg, ctx.seed, dev)
    opt = PT.make_optimizer(model.named_parameters(), base_lr=tc["lr"], weight_decay=tc["weight_decay"],
                            grad_clip=tc["grad_clip"])
    state = PT.TrainState(model, opt)
    sched = D.tamf_schedule(int(cfg["diffusion"]["steps"]), cfg["diffusion"]["noise_schedule"]).to(dev)
    step_fn = PT.make_g_train_step(sched, mano, common.program_assets(dev), _extra_cfg(tc["loss"]),
                                   chunk=int(tc["chunk"]), dist_impl=ctx.traffic["dist_impl"])
    ctx.mark("model, optimizer and step")
    b = int(tc["batch_size"])  # a rank's rows
    bs = b * ctx.world
    groups, table = _pool(ctx, bs)
    ctx.mark("segments")
    batches = [segments.collate(g, int(dcfg["max_nobj"]), table) for g in groups]  # global batches
    pool = [common.rank_rows(g, ctx.rank, b) for g in batches]
    gen = torch.Generator(device=dev)
    ctx.mark("collate")

    losses = []
    named = dict(model.named_parameters())
    for k in range(3):  # the checked steps, then one warm step
        gen.manual_seed(seeds.sub(ctx.seed, f"step{k}"))
        seeds.seed_global(dev, ctx.seed, common.dropout_tag(k, ctx.rank))
        losses.append(step_fn(state, device_batch(pool[k], dev), generator=gen)["loss"])
        if k == 0:
            g1 = compare.first_gradients(opt.adamw, named)
    p3 = common.named_clone(model)
    ctx.mark("three checked steps")
    step_fn(state, device_batch(pool[3 % len(pool)], dev), generator=gen)
    losses = [float(v) for v in losses]
    ctx.mark("warm step")

    kernels = (chamfer_signed.KERNEL, chamfer_loss.KERNEL)

    def step(i):
        step_fn(state, device_batch(pool[(4 + i) % len(pool)], dev), generator=gen)

    def count_launches():
        for kern in kernels:
            kern.launches = 0

    n, m = common.drive(ctx, step, count_launches)
    ctx.mark("window")
    launches = {k.name: k.launches for k in kernels}
    del state, model, opt, step_fn
    common.free_device(dev)

    prog = {"losses": losses, "g1": g1, "p3": p3}
    ref = reference(ctx, batches)
    ctx.mark("reference")
    checks = compare.train_checks(prog, ref, ctx.limits, ctx.notes)
    readings = {}
    if ctx.control:
        readings = common.control_readings(
            lambda **kw: reference(ctx, batches, **kw), ref,
            lambda got, r: compare.train_checks(got, r, ctx.limits), [("half_batch", {"half": True})])
    timed = [batches[(4 + i) % len(pool)] for i in range(n)]
    traced = [pool[(4 + i) % len(pool)] for i in range(n, n + m)]
    return {
        "attempted": n, "failed": 0,
        "e2e": {"train_samples_per_s": bs * n / ctx.window.seconds},
        "checks": checks, "readings": readings,
        "layer": {"work_flops": sum(step_flops(cfg, g) for g in timed)},
        "traced": {"steps": m, "launches": launches,
                   "bound_s": {"nn_signed": sum(bound_nn_signed(cfg, b) for b in traced),
                               "dist_loss": sum(bound_dist_loss(cfg, b) for b in traced)}},
    }


def step_flops(cfg: dict, batch: dict) -> float:
    """One G train step: the trunk forward and backward, MANO of the GT and
    (forward and backward) of the prediction, the GT and predicted searches."""
    bs, L = batch["mask"].shape
    nobj = int(cfg["data"]["max_nobj"])
    live = work.live_frames(batch["mask"], batch["obj_mask"])
    return (3 * bs * work.g_forward(cfg["g_model"], L, nobj) + 4 * bs * L * work.mano_frame()
            + 2 * work.search(live, int(cfg["data"]["n_obj_points"])))


def bound_nn_signed(cfg: dict, batch: dict) -> float:
    live = work.live_frames(batch["mask"], batch["obj_mask"])
    P = int(cfg["data"]["n_obj_points"])
    return work.bound_s(work.search(live, P), work.signed_bytes(live, batch["obj_mask"].size, P))


def bound_dist_loss(cfg: dict, batch: dict) -> float:
    live = work.live_frames(batch["mask"], batch["obj_mask"])
    P = int(cfg["data"]["n_obj_points"])
    return work.bound_s(work.search(live, P), work.dist_loss_bytes(live, batch["obj_mask"].size, P))


def reference(ctx: common.Context, batches, half: bool = False) -> dict:
    """The reference's first three steps on the same global batches and
    seeds, one block of rows for each rank (on the first half of each
    block's rows with `half`)."""
    from ..lib import assets as A
    from ..reference import diffusion as RD
    from ..reference import steps as RS

    cfg, dev, tc = ctx.cfg, ctx.device, ctx.cfg["train"]
    model = common.reference_g(cfg, ctx.seed, dev)
    opt = RS.Optimizer(model.named_parameters(), lr=tc["lr"], grad_clip=tc["grad_clip"],
                       weight_decay=tc["weight_decay"])
    sched = RD.cosine_schedule(int(cfg["diffusion"]["steps"]), dev)
    mano, faces = A.reference_mano(dev)
    assets = A.reference_assets(dev)
    gen = torch.Generator(device=dev)
    named = dict(model.named_parameters())
    p0 = common.named_clone(model)
    losses = []
    for k in range(3):
        batch = segments.to_device(common.half_batch(batches[k], ctx.world) if half else batches[k], dev)
        gen.manual_seed(seeds.sub(ctx.seed, f"step{k}"))
        losses.append(RS.g_step(model, opt, sched, mano, faces, assets, tc["loss"], batch, gen, ctx.world,
                                lambda s, k=k: seeds.seed_global(dev, ctx.seed, common.dropout_tag(k, s))))
        if k == 0:
            g1 = compare.first_gradients(opt.adamw, named)
    return {"losses": losses, "g1": g1, "p0": p0, "p3": common.named_clone(model)}
