"""G -> R sampling: one client in a closed loop calling the program's
`serving.TamfPipeline.generate` on `segments_per_call` distinct segments of
a pool, each call with a device generator seeded from the run's seed and
the call's number. The window closes at the end of the first call that
ends after `--seconds`.

The pipeline is built from the program's classes with the benchmark's
weights, MANO and text features: the text features of each prompt are the
benchmark's inputs (they stand in for CLIP's cached features), served by a
table in the place of the pipeline's text encoder.

After the window the program is freed and the reference runs one of the
finished calls, drawn from the seed, on the same segments and noise seed;
the four returned arrays are compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..lib import compare, seeds, segments, work
from . import common


class TextTable:
    """encode_text(texts) -> [n, 512] rows of the benchmark's feature table."""

    def __init__(self, table: np.ndarray, device):
        self.rows = torch.from_numpy(table).to(device)

    def encode_text(self, texts) -> torch.Tensor:
        return self.rows[[segments.prompt_id(t) for t in texts]]


def run(ctx: common.Context) -> dict:
    from oakink2_tamf_tpu_torch import serving
    from oakink2_tamf_tpu_torch.core import diffusion as D

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    dcfg = cfg["data"]
    per_call = int(tr["segments_per_call"])
    g_model = common.program_g(cfg, ctx.seed, dev).eval().requires_grad_(False)
    r_net = common.program_r(cfg, ctx.seed, dev).eval().requires_grad_(False)
    table = segments.text_table(ctx.seed, int(tr.get("n_prompts", 7)))
    pipe = serving.TamfPipeline(
        g_model=g_model, refine_net=r_net,
        sched=D.tamf_schedule(int(cfg["diffusion"]["steps"]), cfg["diffusion"]["noise_schedule"]).to(dev),
        mano_stack=common.program_mano(dev), clip=TextTable(table, dev), device=dev,
        batch_size=per_call, seq_len=int(dcfg["seq_len"]), max_nobj=int(dcfg["max_nobj"]),
        n_obj_points=int(dcfg["n_obj_points"]), sampler=tr["sampler"],
    )
    ctx.mark("models and pipeline")
    pool = segments.make_segments(ctx.seed, "pool", per_call * int(tr["pool_calls"]), common.data_params(cfg, tr),
                                  group=per_call)
    calls = common.host_batches(pool, per_call)
    ctx.mark("segments")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seeds.sub(ctx.seed, "warm"))
    pipe.generate(calls[-1], generator=gen)  # warm: the chain's shapes, R's kernels
    ctx.mark("warm call")

    results, stamps = [], []

    def call(i):
        gen.manual_seed(seeds.sub(ctx.seed, f"call{i}"))
        results.append(pipe.generate(calls[i % len(calls)], generator=gen))
        stamps.append(time.perf_counter())

    n, m = common.drive(ctx, call)
    ctx.notes.append("call ends (s): " + " ".join(f"{t - ctx.window.t0:.4f}" for t in stamps[:n]))
    ctx.mark("window")
    del pipe, g_model, r_net
    common.free_device(dev)

    k = int(seeds.rng(ctx.seed, "checked call").integers(n))
    ref = reference(ctx, calls[k % len(calls)], table, seeds.sub(ctx.seed, f"call{k}"))
    ctx.mark("reference")
    got = {key: np.stack([r[key] for r in results[k]]) for key in ANSWERS}
    checks = answer_checks(got, ref, ctx.limits)
    readings = {}
    if ctx.control:
        readings = common.control_readings(
            lambda: reference(ctx, calls[k % len(calls)], table, seeds.sub(ctx.seed, f"call{k}")), ref,
            lambda ctrl, r: answer_checks(ctrl, r, ctx.limits))
    own = [segments.collate(c, int(dcfg["max_nobj"])) for c in calls]
    return {
        "attempted": n * per_call, "failed": 0,
        "e2e": {"sample_segments_per_s": n * per_call / ctx.window.seconds},
        "checks": checks, "readings": readings,
        "layer": {"work_flops": sum(call_flops(cfg, own[i % len(own)]) for i in range(n))},
        "traced": {"g_steps": m * int(cfg["diffusion"]["steps"])},
    }


ANSWERS = {"g_sample_pose_repr": "g_sample_gap", "refine_pose_repr": "refine_gap",
           "verts": "verts_gap_m", "joints": "joints_gap_m"}


def answer_checks(got: dict, ref: dict, limits: dict) -> list:
    """The largest absolute difference of each returned array."""
    return [(name, compare.max_abs(torch.as_tensor(got[key]).cpu(), ref[key].cpu()), limits[name])
            for key, name in ANSWERS.items()]


def call_flops(cfg: dict, batch: dict) -> float:
    """One call: G's forward at every step of the chain, then R's forward,
    MANO of the sample and of the refined pose, and the sample's search."""
    bs, L = batch["mask"].shape
    nobj = int(cfg["data"]["max_nobj"])
    live = work.live_frames(batch["mask"], batch["obj_mask"])
    return (int(cfg["diffusion"]["steps"]) * bs * work.g_forward(cfg["g_model"], L, nobj)
            + bs * work.r_forward(cfg["r_model"], L, nobj) + 2 * bs * L * work.mano_frame()
            + work.search(live, int(cfg["data"]["n_obj_points"])))


def reference(ctx: common.Context, call: list[dict], table: np.ndarray, noise_seed: int) -> dict:
    from ..lib import assets as A
    from ..reference import diffusion as RD
    from ..reference import steps as RS

    cfg, dev = ctx.cfg, ctx.device
    batch = segments.to_device(segments.collate(call, int(cfg["data"]["max_nobj"]), table), dev)
    mano, faces = A.reference_mano(dev)
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
    return RS.generate(common.reference_g(cfg, ctx.seed, dev), common.reference_r(cfg, ctx.seed, dev),
                       RD.cosine_schedule(int(cfg["diffusion"]["steps"]), dev), mano, faces, batch, gen)
