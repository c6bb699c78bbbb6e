#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (oakink2_tamf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
1. build the CUDA kernels from ops/csrc (one nvcc per source, in parallel);
2. serving kernels: check each against its plain PyTorch version on the
   card at the serving path's shapes (10240 frames = 64 clouds x 160
   frames, 778 hand rows, 2048 / 8192 object points) with ragged y_valid,
   one all-invalid cloud and x_valid=False frames; check that the two
   kernels' values are bit-identical on valid frames; time kernel, plain
   version and torch.cdist(...).amin(-1) as the library yardstick;
3. training kernels (signed pair forward and backward, fused loss): check
   each against its plain version at 8192 points and 778 rows on 32 frames,
   with a ragged cloud, an all-zero padded slot and x_valid=False frames;
   then time each kernel at the G training shape (40960 frames = batch 64
   x 4 object slots x 160 frames), its plain version on 1/8 of those
   frames (x 8), and torch.cdist with min/argmin both ways as the signed
   forward's library yardstick;
4. R kernels (#3 culled dvec, #4 all-pairs dvec, #5 h2o backward): check
   each against its plain version on 32 frames x 778 rows x 8192 points
   (ragged cloud, all-invalid cloud, x_valid=False frames; #5 in both
   grad_y modes); time them at the R training shape (40960 frames against
   8192 points for #3 and 2048 for #4; #5 at 10240 x 778 x 2048) and hold
   them against their plain versions there too (#3/#4 on the 1/8 of the
   frames the plain versions are timed on);
5. cluster kernels (#10 h2o over candidate cells, #11 its backward, #12
   o2h over candidate tiles, #13 its backward) on the R main path's own
   operands (sample hands in the canonical frames of a full-width batch,
   template permutation): each against its plain version; #10 against #1
   (equal on rows of certified tiles, never below; the overflowed-tile
   share is printed); #12 at k_tiles 0 against #6's o2h half; each timed
   at 40960 frames x 778 x 8192 with the selection stage;
6. small GPU-vs-CPU parity: the serving pipeline, a G train step on both
   dist routes and an R train step on all three h2o routes (same weights,
   batch and noise, dropout 0): loss and gradients must agree;
7. the G training main path: arch_mdm_l, batch 64 x 160 frames x 4 objects
   x 8192 points, 1000-step cosine schedule, dist_impl="auto" (fused),
   synthetic segments, one warm-up step then 3 timed steps; the signed
   forward (GT side) and the fused loss kernel must launch once per step;
   then the step's split on the same batch;
8. the composed route: the same model and batch, 2 steps; the signed
   forward and its backward kernel must launch;
9. the entry point: launch/train_g.main on config/synthetic_smoke.yml on
   the card (two short epochs);
10. the gt_geom cache: train_g.main with train.data.cache_gt_geom (the
   signed forward runs in the precompute, not in the steps), then a fresh
   cache's cold misses computed in the loader's threads against the
   batched precompute;
11. the R training main path, cull route: arch_refine, batch 64 x 160
   frames x 4 objects x 8192 points with target_h2o from TargetH2OCache,
   one warm-up step then 3 timed steps and the step's split; #2 and #3
   must launch once per step; then 2 steps of the all-pairs route at 2048
   points (#4 must launch);
12. launch/train_r.main on config/synthetic_smoke.yml on the card;
13. the R training main path, cluster route (train.h2o_backend cluster):
   the same model and batch shape, 3 timed steps and the split; #10 must
   launch twice and #11 once per step, #1-#5 never; the val probe's
   overflow count on the batch;
14. core/geometry.point2point_signed(backend="cluster") under autograd
   (#10, #11, #12, #13 once each) against the exact signed pair;
15. launch/train_r.main with --train.h2o_backend cluster --train.val_freq
   1: the val passes must log the certificate;
16. autograd through point2point_h2o(grad_y=True), GPU against CPU (#1
   forward, #5 backward);
17. the serving main path, cull route: TamfPipeline at arch_mdm_l G,
   default R, synthetic MANO, random-init CLIP with the hash tokenizer,
   1000 DDPM steps, batch 16 x 160 frames x 4 objects x 8192 points; one
   generate of 16 segments; the culled kernel must have launched;
18. the all-pairs route: the same at 2048 points with 50 respaced steps; the
   all-pairs kernel must have launched.

The line before the last is the card's name and power limit
(nvidia-smi); before it, one JSON line with every kernel's numbers. The
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, HBM3 bandwidth. Used only for bound_ms.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FLOPS_PER_PAIR = 8  # 3 sub, 3 mul, 2 add per squared distance


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"smoke check failed: {msg}")


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_timed(fn):
    """(fn(), its ms on the card) for one run: a plain version's output is
    checked and its time kept from the same run."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(n_bytes: float, n_pairs: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_inputs(P2: int, G: int = 64, L: int = 160, P1: int = 778, seed: int = 0):
    """Hand-sized clusters near spatially sorted object clouds; group 1 has a
    ragged y_valid, group 2 is all-invalid (a padded object slot), every 7th
    frame is x_valid=False (a mask-padded frame)."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.utils.pc_util import spatial_sort_indices

    rng = np.random.default_rng(seed)
    y = rng.normal(scale=0.1, size=(G, P2, 3)).astype(np.float32)
    for g in range(G):
        y[g] = y[g][spatial_sort_indices(y[g])]
    centers = rng.normal(scale=0.1, size=(G * L, 7, 3)).astype(np.float32)
    x = centers[:, np.minimum(np.arange(P1) // 128, 6)] + rng.normal(scale=0.015, size=(G * L, P1, 3))
    y_valid = np.ones((G, P2), bool)
    y_valid[1, rng.integers(P2 // 4, P2):] = False
    y_valid[2] = False
    x_valid = np.ones(G * L, bool)
    x_valid[::7] = False
    dev = "cuda"
    return (torch.from_numpy(x.astype(np.float32)).to(dev), torch.from_numpy(y).to(dev),
            torch.from_numpy(y_valid).to(dev), torch.from_numpy(x_valid).to(dev), L)


def library_min(xc, yc, groups: int = 4):
    """The library yardstick, torch.cdist(x, y).amin(-1), over `groups`
    clouds per call: one call over all 64 clouds of the main path would need
    a [64, 124480, P2] distance matrix (up to 260 GB)."""
    import torch

    return torch.cat([torch.cdist(xc[g : g + groups], yc[g : g + groups]).amin(-1)
                      for g in range(0, xc.shape[0], groups)])


def check_kernels() -> dict[str, dict]:
    """Both kernels at the main path's shapes: 64 clouds x 160 frames =
    10240 frames (16 samples x 4 object slots), 778 rows, 2048 points for
    the all-pairs kernel and 8192 for the culled one."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    out = {}
    # tolerance kernel vs plain: the plain version repeats the kernel's
    # rounding (f32 subtract, f32 mul, two once-rounded fmas), so only a
    # rare double rounding in its f64 fma emulation may differ: 1 ulp
    rtol = 2.0**-23
    # --- all-pairs kernel at 2048 points --------------------------------
    x, y, yv, xv, L = kernel_inputs(2048)
    ops = NN.prepare(x, y, yv, L)
    d, idx = NN.launch(*ops, L)
    torch.cuda.synchronize()
    dp, ip = NN.plain(*ops, L)
    err = (d - dp).abs().max().item()
    require(torch.allclose(d, dp, rtol=rtol, atol=0.0), f"h2o_nn vs plain: max abs err {err}")
    require(torch.equal(idx, ip), "h2o_nn argmin differs from the plain version")
    del dp, ip
    F, P1 = d.shape
    G, P2 = y.shape[:2]
    xc = NN.centred_x(ops[0], ops[2], L).reshape(G, L * P1, 3)
    yc = ops[1][..., :3].contiguous()
    n_bytes = x.numel() * 4 + y.numel() * 4 + F * P1 * 8
    b, by = bound_ms(n_bytes, F * P1 * P2)
    out["h2o_nn"] = dict(
        kernel=NN.KERNEL, max_abs_err=err, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: NN.launch(*ops, L), reps=10),
        plain_ms=cuda_time_ms(lambda: NN.plain(*ops, L), reps=1),
        library_ms=cuda_time_ms(lambda: library_min(xc, yc), reps=3),
        bound_ms=b, bound_by=by,
    )
    o = out["h2o_nn"]
    print(f"h2o_nn   F={F} P1={P1} P2={P2}: max_abs_err={err} ms={o['ms']:.4f} "
          f"plain_ms={o['plain_ms']:.3f} library_ms={o['library_ms']:.3f} "
          f"bound_ms={b:.4f} ({by})", flush=True)
    del x, y, ops, d, idx, xc, yc
    torch.cuda.empty_cache()

    # --- culled kernel at 8192 points, and bit-identity with all-pairs ----
    x, y, yv, xv, L = kernel_inputs(8192, seed=1)
    tile = 2048
    mask = CU.cull_mask(x, y, yv, tile, L, xv)
    ops = NN.prepare(x, y, yv, L)
    dc = CU.launch(*ops, mask, L, tile)
    torch.cuda.synchronize()
    dcp = CU.plain(*ops, mask, L, tile)
    err = (dc - dcp).abs().max().item()
    require(torch.allclose(dc, dcp, rtol=rtol, atol=0.0), f"h2o_cull vs plain: max abs err {err}")
    del dcp
    da, _ = NN.launch(*ops, L)
    torch.cuda.synchronize()
    valid_rows = (xv & yv.any(dim=1).repeat_interleave(L))[:, None].expand_as(dc)
    require(torch.equal(dc[valid_rows], da[valid_rows]), "h2o_cull and h2o_nn values differ on valid frames")
    require(bool((dc[~valid_rows] == CU.BIG).all()), "culled rows are not BIG")
    print("h2o_cull and h2o_nn: bit-identical on valid frames", flush=True)
    F, P1 = dc.shape
    G, P2 = y.shape[:2]
    R, T = mask.shape[1:]
    rows = torch.tensor([min(128, P1 - 128 * r) for r in range(R)], device=mask.device)
    cols = torch.tensor([min(tile, P2 - tile * t) for t in range(T)], device=mask.device)
    pairs = float((mask * rows[None, :, None] * cols[None, None, :]).sum())
    n_bytes = x.numel() * 4 + y.numel() * 4 + mask.numel() * 4 + F * P1 * 4
    b, by = bound_ms(n_bytes, pairs)
    xc = NN.centred_x(ops[0], ops[2], L).reshape(G, L * P1, 3)
    yc = ops[1][..., :3].contiguous()
    out["h2o_cull"] = dict(
        kernel=CU.KERNEL, max_abs_err=err, shape=[F, P1, P2], run_fraction=mask.float().mean().item(),
        ms=cuda_time_ms(lambda: CU.launch(*ops, mask, L, tile), reps=10),
        plain_ms=cuda_time_ms(lambda: CU.plain(*ops, mask, L, tile), reps=1),
        library_ms=cuda_time_ms(lambda: library_min(xc, yc), reps=2),
        mask_ms=cuda_time_ms(lambda: CU.cull_mask(x, y, yv, tile, L, xv), reps=3),
        all_pairs_ms=cuda_time_ms(lambda: NN.launch(*ops, L), reps=5),
        bound_ms=b, bound_by=by,
    )
    o = out["h2o_cull"]
    print(f"h2o_cull F={F} P1={P1} P2={P2}: max_abs_err={err} ms={o['ms']:.4f} "
          f"plain_ms={o['plain_ms']:.3f} library_ms={o['library_ms']:.3f} bound_ms={b:.4f} ({by}) "
          f"run_fraction={o['run_fraction']:.4f} mask_ms={o['mask_ms']:.4f} "
          f"h2o_nn at 8192 points ms={o['all_pairs_ms']:.4f}", flush=True)
    del x, y, ops, dc, da, xc, yc, mask
    torch.cuda.empty_cache()
    return out


def small_parity() -> None:
    """A tiny pipeline on the GPU (kernels) and on the CPU (plain versions)
    with the same weights and noise, on both h2o routes."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig
    from oakink2_tamf_tpu_torch.serving import TamfPipeline

    small = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=2, dropout=0.0)
    for P in (4096, 256):
        kw = dict(g_config=MDMConfig(**small), r_config=RefineConfig(**small), diffusion_steps=4,
                  batch_size=2, seq_len=16, max_nobj=2, n_obj_points=P)
        gpu = TamfPipeline.load(device="cuda", **kw)
        cpu = TamfPipeline.load(device="cpu", **kw)
        segs = [SyntheticSegments(2, seq_len=16, max_nobj=2, n_obj_points=P)[i] for i in range(2)]
        g = torch.Generator().manual_seed(3)
        noise = [(torch.randn(2, 16, 99, generator=g), torch.randn(4, 2, 16, 99, generator=g))]
        a = gpu.generate(segs, noise=noise)
        b = cpu.generate(segs, noise=noise)
        for ra, rb in zip(a, b):
            for k in ("refine_pose_repr", "verts", "joints"):
                # fp32 GPU vs CPU matmul order through 4 chain steps and R
                err = float(np.abs(ra[k] - rb[k]).max())
                require(err < 1e-3, f"GPU vs CPU pipeline at P={P}: {k} differs by {err}")
        print(f"small pipeline P={P}: GPU (kernels) matches CPU (plain) within 1e-3", flush=True)


def main_path(n_obj_points: int, respacing: str, kernel, label: str):
    """One generate of 16 segments at the serving shapes; the kernel's count
    is set to 0 just before and read just after."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.serving import TamfPipeline

    t0 = time.perf_counter()
    pipe = TamfPipeline.load(
        device="cuda", diffusion_steps=1000, timestep_respacing=respacing,
        batch_size=16, seq_len=160, max_nobj=4, n_obj_points=n_obj_points,
    )
    ds = SyntheticSegments(16, seq_len=160, max_nobj=4, n_obj_points=n_obj_points, seed=11)
    segs = [ds[i] for i in range(16)]
    torch.cuda.synchronize()
    print(f"{label}: load + segments {time.perf_counter() - t0:.2f} s", flush=True)

    NN.KERNEL.launches = 0
    CU.KERNEL.launches = 0
    t0 = time.perf_counter()
    res = pipe.generate(segs, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"h2o_nn": NN.KERNEL.launches, "h2o_cull": CU.KERNEL.launches}
    print(f"{label}: generate(16) {wall:.3f} s = {16 / wall:.3f} samples/s over "
          f"{pipe.sched.num_timesteps} steps; launches {counts}", flush=True)
    require(counts[kernel] > 0, f"{label}: the {kernel} kernel never launched")
    require(len(res) == 16, f"{label}: {len(res)} results")
    for r in res:
        require(r["refine_pose_repr"].shape == (160, 99), "refine_pose_repr shape")
        require(r["verts"].shape == (160, 778, 3), "verts shape")
        require(r["joints"].shape == (160, 21, 3), "joints shape")
        require(all(np.isfinite(v).all() for v in r.values()), f"{label}: non-finite output")

    # where the time goes: G chain and R alone on the same batch (not counted)
    batch = pipe._device_batch(segs)
    with torch.inference_mode():
        cond = {k: batch[k] for k in ("text_emb", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask")}
        x = torch.randn(16, 160, 99, device="cuda")
        t = torch.zeros(16, dtype=torch.long, device="cuda")
        g_ms = cuda_time_ms(lambda: pipe.g_model(x, t, cond), reps=10)
        from oakink2_tamf_tpu_torch.models.refine_r import refine_forward

        b2 = dict(batch, sample_pose_repr=batch["pose_repr"])
        r_ms = cuda_time_ms(lambda: refine_forward(pipe.refine_net, pipe.mano_stack, b2, with_target=False,
                                                   loss_frame_mask=batch["mask"]), reps=3)
    print(f"{label}: G forward {g_ms:.3f} ms/step, R forward with geometry {r_ms:.3f} ms", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return counts, wall


# ---------------------------------------------------------------------------
# G training: kernels #6-#8, train-step parity, main path, composed route
# ---------------------------------------------------------------------------

TRAIN_BS, TRAIN_NOBJ, TRAIN_L, TRAIN_P = 64, 4, 160, 8192  # bs_64 x parity.yml x 160 frames
TRAIN_CLOUDS = TRAIN_BS * TRAIN_NOBJ  # 256 canonical clouds, 40960 frames


def scatter_close(a, b, rtol: float = 1e-5) -> bool:
    """Per frame, ||a_f - b_f|| <= rtol ||b_f|| + 1e-6: the check for a
    gradient that a kernel accumulates with atomics. The two sides sum the
    same terms in other orders; a row that sums many terms of size ~1 that
    cancel differs by far more than rtol of its own value, but not of the
    frame's gradient."""
    d = (a - b).flatten(1).norm(dim=1)
    return bool((d <= rtol * b.flatten(1).norm(dim=1) + 1e-6).all())


def scatter_mass_close(a, b, mass, rtol: float = 1e-6) -> bool:
    """Per frame, ||a_f - b_f|| <= rtol ||mass_f|| + 1e-6, with mass the
    same scatter of the terms' absolute values: the check for an o2h-side
    gradient, where thousands of object points with cotangents of either
    sign land on the few hand rows nearest the object. Two float32 sums of
    the same terms in other orders differ by a few ulps of the sum of the
    terms' magnitudes, which there is orders of magnitude above the
    cancelled sum itself."""
    d = (a - b).flatten(1).norm(dim=1)
    return bool((d <= rtol * mass.flatten(1).norm(dim=1) + 1e-6).all())


def o2h_mass(x, y, o2h_i, yc):
    """[F, P1, 3]: the scatter of |yc_j (y_j - x_{o2h_i[j]})| onto the rows
    (one cloud per frame): the magnitude that #13's and #7's o2h-side
    atomics sum."""
    import torch

    F, P1, _ = x.shape
    flat = (torch.arange(F, device=x.device)[:, None] * P1 + o2h_i.long()).reshape(-1)
    u = (yc[..., None] * (y - x.reshape(-1, 3)[flat].reshape(y.shape))).abs()
    return torch.zeros((F * P1, 3), device=x.device).index_add_(0, flat, u.reshape(-1, 3)).reshape(x.shape)


def training_scene(G: int, L: int, seed: int, P2: int = TRAIN_P, P1: int = 778):
    """Operands of the training kernels: kernel_inputs' hand clusters near
    spatially sorted clouds, unit normals, GT fields of hand scale and
    contact weights. Group 1 has a ragged y_valid; group 2 is an all-zero
    padded slot (zero cloud, zero canonical rows, valid, as the loss passes
    it); every 7th frame is x_valid=False."""
    import numpy as np
    import torch

    x, y, yv, xv, _ = kernel_inputs(P2, G=G, L=L, P1=P1, seed=seed)
    yv[2] = True
    y[2] = 0.0
    x[2 * L : 3 * L] = 0.0
    rng = np.random.default_rng(seed + 100)
    n = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(size=(G * L, P1, 3)).astype(np.float32)).cuda(), dim=-1
    )
    og = torch.from_numpy((rng.normal(size=(G * L, P2)) * 0.01).astype(np.float32)).cuda()
    hg = torch.from_numpy((np.abs(rng.normal(size=(G * L, P1))) * 0.01).astype(np.float32)).cuda()
    vw = torch.from_numpy(rng.random(P1).astype(np.float32)).cuda()
    return x, n, y, yv, xv, og, hg, vw


def library_signed(xc, yc, L: int, P1: int, groups: int = 2):
    """The signed forward's library yardstick: torch.cdist over `groups`
    clouds per call, then min and argmin in both directions (h2o over the
    points, o2h over each frame's rows); no sign numerator."""
    import torch

    out = []
    for g in range(0, xc.shape[0], groups):
        d = torch.cdist(xc[g : g + groups], yc[g : g + groups])  # [groups, L*P1, P2]
        out.append(torch.min(d, dim=-1))
        out.append(torch.min(d.reshape(d.shape[0], L, P1, -1), dim=-2))
    return out


def check_training_kernels() -> dict[str, dict]:
    """#6 nn_signed, #7 nn_signed_bwd and #8 dist_loss: against their plain
    versions on 32 frames (4 clouds x 8) at 8192 points, then timed at the
    G training shape (256 clouds x 160 frames)."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    out = {}
    # --- correctness, reduced frame count ----------------------------------
    L = 8
    x, n, y, yv, xv, og, hg, vw = training_scene(4, L, seed=2)
    ops = CS.prepare(x, y, n, yv, L)
    got = CS.launch(*ops, L)
    torch.cuda.synchronize()
    want = CS.plain(*ops, L)
    # the plain version repeats the kernel's per-pair rounding: equal values
    # and first-min indices
    names = ("h2o_d", "h2o_i", "o2h_d", "o2h_i", "o2h_dot")
    for nm, a, b in zip(names, got, want):
        require(torch.equal(a, b), f"nn_signed {nm} differs from the plain version")
    err6 = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    print(f"nn_signed F={x.shape[0]} P1=778 P2={TRAIN_P}: equal to plain (max abs err {err6})", flush=True)

    h2o_i, o2h_i = got[1], got[3]
    xr = torch.randn(x.shape[0], 778, device="cuda")
    yc = torch.randn(x.shape[0], TRAIN_P, device="cuda") * yv.repeat_interleave(L, 0)
    # atomics sum in a run-dependent order: per-frame norm within 1e-5
    err7 = 0.0
    for grad_y, gl in ((False, L), (True, 1)):
        yy = y if gl == L else y.repeat_interleave(L, 0).contiguous()
        gx, gy = CS.backward_launch(x, yy, h2o_i, o2h_i, xr, yc, grad_y, gl)
        px, py = CS.backward_plain(x, yy, h2o_i, o2h_i, xr, yc, grad_y, gl)
        pairs = [(gx, px)] + ([(gy, py)] if grad_y else [])
        for a, b in pairs:
            require(scatter_close(a, b), f"nn_signed_bwd (grad_y={grad_y}) vs plain")
            err7 = max(err7, (a - b).abs().max().item())
    print(f"nn_signed_bwd nogy and grad_y: plain within 1e-5 per frame (max abs err {err7})", flush=True)

    lops = CL.prepare(x, n, y, og, hg, vw, yv, xv, L)
    got = CL.launch(*lops, L)
    torch.cuda.synchronize()
    want = CL.plain(*lops, L)
    err8 = 0.0
    # v, dh, gx_dh: the same float32 operations (one ulp of a sqrt may
    # differ); gx_do: shared-memory atomics in a run-dependent order
    for nm, a, b in zip(("v", "dh", "gx_dh"), (got[0], got[1], got[3]), (want[0], want[1], want[3])):
        require(torch.allclose(a, b, rtol=1e-6, atol=1e-7), f"dist_loss {nm} vs plain: {(a - b).abs().max().item()}")
        err8 = max(err8, (a - b).abs().max().item())
    require(scatter_close(got[2], want[2]), f"dist_loss gx_do vs plain: {(got[2] - want[2]).abs().max().item()}")
    err8 = max(err8, (got[2] - want[2]).abs().max().item())
    dead = ~xv
    require(bool((got[0][dead] == 0).all() and (got[2][dead] == 0).all()), "x_valid=False frames not zero")
    print(f"dist_loss: plain within tolerance (max abs err {err8}), x_valid=False frames zero", flush=True)
    del x, n, y, yv, xv, og, hg, vw, ops, lops, got, want, xr, yc, gx, gy, px, py
    torch.cuda.empty_cache()

    # --- timing at the G training shape ------------------------------------
    L = TRAIN_L
    x, n, y, _, xv, og, hg, vw = training_scene(TRAIN_CLOUDS, L, seed=3)
    F, P1, _ = x.shape
    P2 = y.shape[1]
    ops = CS.prepare(x, y, n, None, L)  # the loss passes no y_valid
    pairs = F * P1 * P2
    n_bytes = 2 * x.numel() * 4 + y.numel() * 4 + F * P1 * 8 + F * P2 * 12
    b, by = bound_ms(n_bytes, pairs)
    fwd = CS.launch(*ops, L)
    xc = NN.centred_x(ops[0], ops[3], L).reshape(TRAIN_CLOUDS, L * P1, 3)
    # the plain versions are timed on 1/8 of the frames (clouds) and scaled
    # by 8, as the R kernels' are: a full-size plain run takes ~33 s each
    f8, g8 = F // 8, TRAIN_CLOUDS // 8
    out["nn_signed"] = dict(
        kernel=CS.KERNEL, max_abs_err=err6, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: CS.launch(*ops, L), reps=3),
        plain_ms=8 * cuda_time_ms(lambda: CS.plain(ops[0][:f8], ops[1][:f8], ops[2][:g8], ops[3][:g8], L),
                                  reps=1, warmup=0),
        library_ms=cuda_time_ms(lambda: library_signed(xc, ops[2][..., :3].contiguous(), L, P1), reps=1),
        bound_ms=b, bound_by=by,
    )
    del xc
    h2o_i, o2h_i = fwd[1], fwd[3]
    del fwd
    xr = torch.randn(F, P1, device="cuda")
    yc = torch.randn(F, P2, device="cuda")
    b7, by7 = bound_ms(x.numel() * 4 + y.numel() * 4 + F * P1 * 8 + F * P2 * 8 + F * P1 * 12, 0)
    out["nn_signed_bwd"] = dict(
        kernel=CS.BWD_KERNEL, max_abs_err=err7, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: CS.backward_launch(x, y, h2o_i, o2h_i, xr, yc, False, L), reps=10),
        plain_ms=cuda_time_ms(lambda: CS.backward_plain(x, y, h2o_i, o2h_i, xr, yc, False, L), reps=1, warmup=0),
        library_ms=None, bound_ms=b7, bound_by=by7,
    )
    del h2o_i, o2h_i, xr, yc
    torch.cuda.empty_cache()
    lops = CL.prepare(x, n, y, og, hg, vw, None, xv, L)
    live = int(xv.sum())
    b8, by8 = bound_ms(2 * x.numel() * 4 + y.numel() * 4 + F * P2 * 8 + F * P1 * 8 + F * P1 * 24,
                       live * P1 * P2)
    out["dist_loss"] = dict(
        kernel=CL.KERNEL, max_abs_err=err8, shape=[F, P1, P2], live_frames=live,
        ms=cuda_time_ms(lambda: CL.launch(*lops, L), reps=3),
        plain_ms=8 * cuda_time_ms(lambda: CL.plain(*(t[:f8] for t in lops[:2]), *(t[:g8] for t in lops[2:4]),
                                                   lops[4][:f8], lops[5][:f8], lops[6], lops[7][:f8], L),
                                  reps=1, warmup=0),
        library_ms=None, bound_ms=b8, bound_by=by8,
    )
    for name, o in ((k, out[k]) for k in ("nn_signed", "nn_signed_bwd", "dist_loss")):
        lib = "none" if o["library_ms"] is None else f"{o['library_ms']:.3f}"
        print(f"{name} F={F} P1={P1} P2={P2}: ms={o['ms']:.4f} plain_ms={o['plain_ms']:.3f} "
              f"library_ms={lib} bound_ms={o['bound_ms']:.4f} ({o['bound_by']})", flush=True)
    print(f"dist_loss live frames {live} of {F}; plain_ms of nn_signed and dist_loss: 8 x the time on 1/8 "
          "of the frames", flush=True)
    del x, n, y, xv, og, hg, vw, ops, lops
    torch.cuda.empty_cache()
    return out


def _train_batch(bs: int, L: int, nobj: int, P: int, seed: int, clip, device):
    """A collated synthetic batch with CLIP text features, on `device`."""
    from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
    from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
    from oakink2_tamf_tpu_torch.launch import common

    ds = SyntheticSegments(bs, seq_len=L, max_nobj=nobj, n_obj_points=P, seed=seed)
    batch = SegmentCollate(max_nobj=nobj, n_obj_points=P)([ds[i] for i in range(bs)])
    return common.device_batch(common.attach_text_emb(batch, clip), device)


def _g_training(device, cfg, dist_impl: str, seed: int = 0):
    """(state, step_fn) of a G train step on `device`, weights from `seed`."""
    import torch

    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.mdm_g import InteractionSegmentMDM
    from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
    from oakink2_tamf_tpu_torch.parallel import train as PT

    torch.manual_seed(seed)
    model = InteractionSegmentMDM(cfg).to(device)
    state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
    mano = stack_mano_models(M.get_mano_model(None, "right"), M.get_mano_model(None, "left"), device)
    step = PT.make_g_train_step(
        D.tamf_schedule(1000).to(device), mano, LL.load_contact_assets(device=device),
        LL.ExtraLossConfig(), dist_impl=dist_impl,
    )
    return state, step, mano


def small_train_parity() -> None:
    """A small G train step on the GPU (kernels) and on the CPU (plain
    versions): the same weights, batch, t and noise, dropout 0. Loss within
    rtol 1e-4; each parameter's clipped gradient within 2e-3 of its norm
    (+1e-6): fp32 GPU vs CPU matmul order through MANO, the kernels' atomics
    and a 1-layer transformer."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig

    cfg = MDMConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
    rng = np.random.default_rng(6)
    noise = torch.from_numpy(rng.normal(size=(4, 16, 99)).astype(np.float32))
    t = torch.tensor([0, 10, 500, 999])
    for impl in ("fused", "composed"):
        res = {}
        for dev in ("cuda", "cpu"):
            clip = FrozenClipText(device=dev)
            db = _train_batch(4, 16, 2, 512, seed=5, clip=clip, device=dev)
            db.update(t=t.to(dev), t_weights=torch.ones(4, device=dev))
            state, step, _ = _g_training(torch.device(dev), cfg, impl)
            m = step(state, db, noise=noise.to(dev))
            res[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in state.model.named_parameters()})
        la, lb = res["cuda"][0], res["cpu"][0]
        require(abs(la - lb) <= 1e-4 * abs(lb), f"train step {impl}: GPU loss {la} vs CPU {lb}")
        worst = 0.0
        for k, gb in res["cpu"][1].items():
            d = (res["cuda"][1][k] - gb).norm().item()
            require(d <= 2e-3 * gb.norm().item() + 1e-6, f"train step {impl}: grad {k} differs by {d}")
            worst = max(worst, d / (gb.norm().item() + 1e-12))
        print(f"small train step ({impl}): GPU (kernels) vs CPU (plain) loss {la:.6f} / {lb:.6f}, "
              f"worst relative grad diff {worst:.2e}", flush=True)


def train_main_path():
    """G training at full width: arch_mdm_l, batch 64 x 160 frames x 4
    objects x 8192 points, 1000-step cosine schedule, fused dist route; one
    warm-up step, then 3 timed steps with the launch counts set to 0 just
    before; then the split of a step on the same batch."""
    import torch

    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.core import transforms as T
    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
    from oakink2_tamf_tpu_torch.models.refine_r import batch_recover_mano
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    clip = FrozenClipText(device=dev)
    db = _train_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, TRAIN_P, seed=11, clip=clip, device=dev)
    state, step, mano = _g_training(dev, MDMConfig.arch_mdm_l(), "auto")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    print(f"train main path: batch + model {time.perf_counter() - t0:.2f} s "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)", flush=True)
    t0 = time.perf_counter()
    step(state, db, generator=gen)
    torch.cuda.synchronize()
    print(f"train main path: warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    kernels = {"nn_signed": CS.KERNEL, "nn_signed_bwd": CS.BWD_KERNEL, "dist_loss": CL.KERNEL}
    for k in kernels.values():
        k.launches = 0
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        m = step(state, db, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    counts = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = sum(times) / len(times)
    print(f"train main path (fused): steps {[round(x, 4) for x in times]} s, mean {step_s:.4f} s = "
          f"{TRAIN_BS / step_s:.3f} samples/s; losses {losses}; peak memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    require(all(v == v and abs(v) < float("inf") for v in losses), "non-finite training loss")
    require(any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters())), "parameters unchanged")
    require(counts["nn_signed"] == 3, f"nn_signed launched {counts['nn_signed']} times in 3 steps")
    require(counts["dist_loss"] == 3, f"dist_loss launched {counts['dist_loss']} times in 3 steps")
    del before

    # where the step's time goes, each piece alone on the same batch
    model, sched = state.model, D.tamf_schedule(1000).to(dev)
    cond = {k: db[k] for k in ("text_emb", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask")}
    t = torch.randint(0, 1000, (TRAIN_BS,), device=dev, generator=gen)

    def g_fwd_bwd():
        model.zero_grad(set_to_none=True)
        mse, _ = D.training_losses(lambda x, tt: model(x, tt, cond), sched, db["pose_repr"], t,
                                   db["mask"], generator=gen)
        mse.mean().backward()

    def mano_normals():
        with torch.no_grad():
            batch_recover_mano(mano, db["pose_repr"], db["shape"], db["hand_side"])

    with torch.no_grad():
        verts, _, normals = batch_recover_mano(mano, db["pose_repr"], db["shape"], db["hand_side"])
        transf = T.tslrot6d_to_transf(db["obj_traj"])
        o2h_g, h2o_g = LL._per_object_signed(verts, normals, transf, db["obj_points"])

    def gt_pass():
        with torch.no_grad():
            LL._per_object_signed(verts, normals, transf, db["obj_points"])

    def fused_pass():
        v = verts.clone().requires_grad_(True)
        do_f, dh_f = LL._dist_sums_fused(v, normals, transf, db["obj_points"], o2h_g, h2o_g,
                                         torch.rand(778, device=dev), seq_mask=db["mask"],
                                         obj_mask=db["obj_mask"])
        (do_f.sum() + dh_f.sum()).backward()

    split = {
        "G forward+backward": cuda_time_ms(g_fwd_bwd, reps=3),
        "MANO with normals (one hand batch)": cuda_time_ms(mano_normals, reps=3),
        "GT pass (nn_signed + prep)": cuda_time_ms(gt_pass, reps=2),
        "fused pass (dist_loss fwd + bwd + prep)": cuda_time_ms(fused_pass, reps=2),
        "optimizer (clip + AdamW + LR)": cuda_time_ms(state.optimizer.step, reps=3),
    }
    print("train step split (ms, each alone on the same batch): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    del verts, normals, transf, o2h_g, h2o_g
    torch.cuda.empty_cache()
    return state, db, counts, step_s


def composed_route(state, db):
    """The same model and batch on dist_impl="composed", 2 steps: the
    signed forward runs on both sides, its backward kernel on the
    predicted side."""
    import torch

    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS
    from oakink2_tamf_tpu_torch.parallel import train as PT

    dev = torch.device("cuda")
    mano = stack_mano_models(M.get_mano_model(None, "right"), M.get_mano_model(None, "left"), dev)
    step = PT.make_g_train_step(D.tamf_schedule(1000).to(dev), mano, LL.load_contact_assets(device=dev),
                                LL.ExtraLossConfig(), dist_impl="composed")
    gen = torch.Generator(device=dev).manual_seed(1)
    kernels = {"nn_signed": CS.KERNEL, "nn_signed_bwd": CS.BWD_KERNEL, "dist_loss": CL.KERNEL}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        m = step(state, db, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    counts = {name: k.launches for name, k in kernels.items()}
    print(f"composed route: steps {[round(x, 4) for x in times]} s; losses {losses}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}", flush=True)
    require(all(v == v and abs(v) < float("inf") for v in losses), "composed: non-finite loss")
    require(counts["nn_signed"] == 4, f"composed: nn_signed launched {counts['nn_signed']} times in 2 steps")
    require(counts["nn_signed_bwd"] == 2, f"composed: nn_signed_bwd launched {counts['nn_signed_bwd']} times")
    require(counts["dist_loss"] == 0, "composed: the fused kernel launched")
    return counts


def entry_point() -> None:
    """launch/train_g.main on the synthetic smoke config, on the card."""
    import torch

    from oakink2_tamf_tpu_torch.launch import train_g
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    root = os.path.dirname(os.path.abspath(__file__))
    CS.KERNEL.launches = CL.KERNEL.launches = 0
    t0 = time.perf_counter()
    state = train_g.main(["--cfg", os.path.join(root, "config/synthetic_smoke.yml"), "--exp_id", "chip_smoke"])
    torch.cuda.synchronize()
    require(state.step == 4, f"train_g.main took {state.step} steps, expected 4")
    require(all(torch.isfinite(p).all() for p in state.model.parameters()), "train_g.main: non-finite weights")
    require(next(state.model.parameters()).is_cuda, "train_g.main did not run on the card")
    print(f"train_g.main (synthetic_smoke.yml, cuda): 2 epochs, {state.step} steps in "
          f"{time.perf_counter() - t0:.2f} s; launches nn_signed {CS.KERNEL.launches} "
          f"dist_loss {CL.KERNEL.launches}", flush=True)
    require(CS.KERNEL.launches == 4 and CL.KERNEL.launches == 4, "train_g.main did not run the kernels")


def gt_cache_path() -> None:
    """train.data.cache_gt_geom on the card. First launch/train_g.main on
    the smoke config with the cache on: the signed forward (#6) runs in the
    cache's precompute and not in the steps, whose GT side reads the cache
    (the fused loss kernel still launches every step). Then the cache's
    cold-miss path: every sample of a fresh cache at the G training widths
    (160 frames, 4 slots, 8192 points) is computed inside the loader's
    worker threads on their current stream, and must equal the main
    thread's batched precompute. Tolerance: |gt_o2h| and gt_h2o within
    rtol 1e-5 / atol 1e-6 (MANO's matmuls at batch 1 and 16 may round
    apart), at most 0.1% of the signs of gt_o2h apart (near-ties of the
    nearest hand vertex, the signed pair's bound in
    tests/test_torch_target_cache.py)."""
    import threading

    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
    from oakink2_tamf_tpu_torch.data.loader import DataLoader
    from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
    from oakink2_tamf_tpu_torch.data.target_cache import GTGeomCache
    from oakink2_tamf_tpu_torch.launch import train_g
    from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    root = os.path.dirname(os.path.abspath(__file__))
    seen = []
    precompute = GTGeomCache.precompute

    def counted(self, **kw):
        n = precompute(self, **kw)
        torch.cuda.synchronize()
        seen.append((n, CS.KERNEL.launches))
        return n

    CS.KERNEL.launches = CL.KERNEL.launches = 0
    GTGeomCache.precompute = counted
    try:
        state = train_g.main(["--cfg", os.path.join(root, "config/synthetic_smoke.yml"),
                              "--exp_id", "chip_smoke_gt_cache", "--train.data.cache_gt_geom", "true"])
    finally:
        GTGeomCache.precompute = precompute
    torch.cuda.synchronize()
    require(len(seen) == 1 and seen[0][0] == 16 and seen[0][1] >= 1,
            f"train_g.main: gt_geom precompute {seen} (segments, nn_signed launches)")
    require(state.step == 4 and all(torch.isfinite(p).all() for p in state.model.parameters()),
            "train_g.main with the gt_geom cache: wrong step count or non-finite weights")
    require(CS.KERNEL.launches == seen[0][1], f"train_g.main with the gt_geom cache: nn_signed launched "
            f"{CS.KERNEL.launches - seen[0][1]} times in the steps")
    require(CL.KERNEL.launches == 4, f"train_g.main with the gt_geom cache: dist_loss {CL.KERNEL.launches}")
    print(f"train_g.main (synthetic_smoke.yml, cuda, cache_gt_geom): {seen[0][0]} segments precomputed with "
          f"{seen[0][1]} nn_signed launches, none in the {state.step} steps; dist_loss {CL.KERNEL.launches}",
          flush=True)
    del state

    nseg, nobj = 16, 4
    base = SyntheticSegments(nseg, seq_len=TRAIN_L, max_nobj=nobj, n_obj_points=TRAIN_P, seed=9)
    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cuda")
    collate = SegmentCollate(max_nobj=nobj, n_obj_points=TRAIN_P)
    warm = GTGeomCache(base, mano, collate, batch_size=nseg)
    CS.KERNEL.launches = 0
    require(warm.precompute() == nseg, "gt_geom precompute did not compute every segment")
    per_batch = CS.KERNEL.launches  # nn_signed launches for one computed batch
    cold = GTGeomCache(base, mano, collate)
    threads = set()
    compute = cold._compute

    def in_thread(batch):
        threads.add(threading.current_thread().name)
        return compute(batch)

    cold._compute = in_thread
    CS.KERNEL.launches = 0
    loader = DataLoader(cold, batch_size=4, collate_fn=collate, shuffle=False, drop_last=False, num_workers=4)
    n_batches = sum(1 for _ in loader)
    torch.cuda.synchronize()
    require(n_batches == nseg // 4 and len(cold._mem) == nseg, "cold-miss pass: not every sample computed")
    require(threads and threading.main_thread().name not in threads,
            f"cold misses were not computed in loader threads: {threads}")
    require(per_batch >= 1 and CS.KERNEL.launches == nseg * per_batch,
            f"{nseg} cold misses launched nn_signed {CS.KERNEL.launches} times, {per_batch} per batch")
    err = signs = flips = 0
    for i in range(nseg):
        a, b = cold._mem[i], warm._mem[i]
        for k in ("o2h", "h2o"):
            require(a[k].shape == b[k].shape and np.all(np.isfinite(a[k])), f"cold miss {i} {k}: shape or NaN")
            require(np.allclose(np.abs(a[k]), np.abs(b[k]), rtol=1e-5, atol=1e-6),
                    f"cold miss {i} {k} differs from the precompute")
            err = max(err, float(np.abs(np.abs(a[k]) - np.abs(b[k])).max()))
        signs += a["o2h"].size
        flips += int((np.sign(a["o2h"]) != np.sign(b["o2h"])).sum())
    require(flips <= 1e-3 * signs, f"cold miss: {flips} of {signs} gt_o2h signs differ")
    print(f"gt_geom cold misses ({nseg} segments x {TRAIN_L} frames x {nobj} slots x {TRAIN_P} points) in "
          f"{len(threads)} loader threads: {CS.KERNEL.launches} nn_signed launches; equal to the batched "
          f"precompute within tolerance (max abs err {err}, {flips} of {signs} signs apart)", flush=True)


# ---------------------------------------------------------------------------
# R training: kernels #3-#5, train-step parity, main path, all-pairs route,
# entry point, the grad_y route
# ---------------------------------------------------------------------------

R_ALL_PAIRS_P = 2048  # the repo default n_obj_points: the all-pairs route


def library_min_dvec(xc, yc, groups: int = 4):
    """#3/#4's library yardstick: torch.cdist(x, y).min(-1) over `groups`
    clouds per call, then a gather of each row's winning point for dvec."""
    import torch

    out = []
    for g in range(0, xc.shape[0], groups):
        xg, yg = xc[g : g + groups], yc[g : g + groups]
        d, j = torch.cdist(xg, yg).min(-1)
        out.append((d, xg - torch.gather(yg, 1, j[..., None].expand(-1, -1, 3))))
    return out


def library_h2o_bwd(x, y, idx, xr):
    """#5's library yardstick: a gather of y at the argmins, then index_add_
    for the gy scatter (y_group 1)."""
    import torch

    F, P1, _ = x.shape
    P2 = y.shape[1]
    flat = (torch.arange(F, device=x.device)[:, None] * P2 + idx.long()).reshape(-1)
    v = xr[..., None] * (x - y.reshape(-1, 3)[flat].reshape(F, P1, 3))
    gy = torch.zeros((F * P2, 3), device=x.device).index_add_(0, flat, -v.reshape(-1, 3))
    return v, gy


def check_r_kernels() -> dict[str, dict]:
    """#3 h2o_cull_dvec, #4 h2o_nn_dvec and #5 h2o_nn_bwd: against their
    plain versions on 32 frames (4 clouds x 8) x 778 rows x 8192 points with
    a ragged cloud, an all-invalid cloud and x_valid=False frames; then
    timed at the R training shape (40960 frames = 64 x 4 slots x 160
    against 8192 points for #3 and 2048 for #4) and #5 at 10240 x 778 x
    2048 with y_group 1, where each is held against its plain version again
    (#3/#4 on the 1/8 of the frames their plain versions are timed on: 5120
    frames, y_group 160). The plain versions of #3 and #4 are timed on 1/8
    of the frames and scaled by 8."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_h2o_bwd as HB
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    out = {}
    tile = 2048
    # --- correctness -----------------------------------------------------
    L = 8
    x, y, yv, xv, _ = kernel_inputs(TRAIN_P, G=4, L=L, seed=4)
    ops = NN.prepare(x, y, yv, L)
    took = yv.any(1).repeat_interleave(L)  # frames whose cloud has a valid point
    d, dvec = NN.launch_dvec(*ops, L)
    torch.cuda.synchronize()
    dp, dvp = NN.plain_dvec(*ops, L)
    # the plain version repeats the per-pair rounding: equal on live rows
    require(torch.equal(d[took], dp[took]) and torch.equal(dvec[took], dvp[took]),
            "h2o_nn_dvec differs from the plain version on live rows")
    require(bool((d[~took] == NN.BIG).all() and (dvec[~took] == 0).all()),
            "h2o_nn_dvec: rows that took no point are not (BIG, 0)")
    require(torch.equal(d, NN.launch(*ops, L)[0]), "h2o_nn_dvec and h2o_nn minima differ")
    err4 = max((d[took] - dp[took]).abs().max().item(), (dvec[took] - dvp[took]).abs().max().item())
    mask = CU.cull_mask(x, y, yv, tile, L, xv)
    dc, dvc = CU.launch_dvec(*ops, mask, L, tile)
    torch.cuda.synchronize()
    dcp, dvcp = CU.plain_dvec(*ops, mask, L, tile)
    live = took & xv
    require(torch.equal(dc[live], dcp[live]) and torch.equal(dvc[live], dvcp[live]),
            "h2o_cull_dvec differs from the plain version on live rows")
    require(bool((dc[~live] == CU.BIG).all() and (dvc[~live] == 0).all()),
            "h2o_cull_dvec: culled rows are not (BIG, 0)")
    require(torch.equal(dc[live], d[live]) and torch.equal(dvc[live], dvec[live]),
            "h2o_cull_dvec and h2o_nn_dvec differ on live frames")
    err3 = max((dc[live] - dcp[live]).abs().max().item(), (dvc[live] - dvcp[live]).abs().max().item())
    print(f"h2o_nn_dvec / h2o_cull_dvec F={x.shape[0]} P1=778 P2={TRAIN_P}: equal to plain on live rows "
          f"(max abs err {err4} / {err3}), (BIG, 0) elsewhere, equal to each other on live frames", flush=True)
    xr = torch.randn(x.shape[:2], device="cuda")
    xr[:, ::7] = 0.0
    err5 = 0.0
    for grad_y, gl in ((False, L), (True, 1)):
        yy = y if gl == L else y.repeat_interleave(L, 0).contiguous()
        _, idx = NN.h2o_nn(x, yy, yv if gl == L else yv.repeat_interleave(L, 0), gl)
        gx, gy = HB.launch(x, yy, idx, xr, grad_y, gl)
        torch.cuda.synchronize()
        px, py = HB.plain(x, yy, idx, xr, grad_y, gl)
        require(torch.equal(gx, px), f"h2o_nn_bwd gx (grad_y={grad_y}) differs from the plain version")
        if grad_y:
            # atomics sum in a run-dependent order: per-frame norm within 1e-5
            require(scatter_close(gy, py), f"h2o_nn_bwd gy vs plain: {(gy - py).abs().max().item()}")
            err5 = (gy - py).abs().max().item()
    print(f"h2o_nn_bwd nogy (y_group {L}) and grad_y ({TRAIN_P} points, {TRAIN_P * 12 // 1024} KB "
          f"accumulator): gx equal, gy within 1e-5 per frame (max abs err {err5})", flush=True)
    del x, y, yv, xv, ops, d, dvec, dp, dvp, mask, dc, dvc, dcp, dvcp, xr, gx, gy, px, py, yy, idx
    torch.cuda.empty_cache()

    # --- timing at the R training shape --------------------------------------
    L = TRAIN_L
    for name, P2 in (("h2o_cull_dvec", TRAIN_P), ("h2o_nn_dvec", R_ALL_PAIRS_P)):
        x, y, yv, xv, _ = kernel_inputs(P2, G=TRAIN_CLOUDS, L=L, seed=5)
        F, P1, _ = x.shape
        ops = NN.prepare(x, y, yv, L)
        part = (F // 8, TRAIN_CLOUDS // 8)  # the plain version's 1/8 of the frames
        if name == "h2o_cull_dvec":
            mask = CU.cull_mask(x, y, yv, tile, L, xv)
            R, T = mask.shape[1:]
            rows = torch.tensor([min(128, P1 - 128 * r) for r in range(R)], device=mask.device)
            cols = torch.tensor([min(tile, P2 - tile * t) for t in range(T)], device=mask.device)
            pairs = float((mask * rows[None, :, None] * cols[None, None, :]).sum())
            n_bytes = x.numel() * 4 + y.numel() * 4 + mask.numel() * 4 + F * P1 * 16
            kernel, run = CU.DVEC_KERNEL, (lambda: CU.launch_dvec(*ops, mask, L, tile))
            plain = (lambda: CU.plain_dvec(ops[0][: part[0]], ops[1][: part[1]], ops[2][: part[1]],
                                           mask[: part[0]], L, tile))
            extra = {"run_fraction": mask.float().mean().item()}
        else:
            pairs = float(F * P1 * P2)
            n_bytes = x.numel() * 4 + y.numel() * 4 + F * P1 * 16
            kernel, run = NN.DVEC_KERNEL, (lambda: NN.launch_dvec(*ops, L))
            plain = lambda: NN.plain_dvec(ops[0][: part[0]], ops[1][: part[1]], ops[2][: part[1]], L)  # noqa: E731
            extra = {}
        b, by = bound_ms(n_bytes, pairs)
        # the kernel against its plain version at the main path's shapes, on
        # the frames the plain version is timed on: live rows bit-identical
        dk, dvk = (t[: part[0]] for t in run())
        dp, dvp = plain()
        live = yv.any(1).repeat_interleave(L)[: part[0]]
        if name == "h2o_cull_dvec":
            live = live & xv[: part[0]]
        require(torch.equal(dk[live], dp[live]) and torch.equal(dvk[live], dvp[live]),
                f"{name} differs from the plain version on live rows at F={part[0]} P2={P2} y_group={L}")
        err = max((dk[live] - dp[live]).abs().max().item(), (dvk[live] - dvp[live]).abs().max().item())
        print(f"{name} F={part[0]} P1={P1} P2={P2} y_group={L}: equal to plain on live rows "
              f"(max abs err {err})", flush=True)
        del dk, dvk, dp, dvp, live
        xc = NN.centred_x(ops[0], ops[2], L).reshape(TRAIN_CLOUDS, L * P1, 3)
        yc = ops[1][..., :3].contiguous()
        out[name] = dict(
            kernel=kernel, max_abs_err=max(err, err3 if name == "h2o_cull_dvec" else err4),
            shape=[F, P1, P2],
            ms=cuda_time_ms(run, reps=3),
            plain_ms=8 * cuda_time_ms(plain, reps=1, warmup=0),
            library_ms=cuda_time_ms(lambda: library_min_dvec(xc, yc), reps=1),
            bound_ms=b, bound_by=by, **extra,
        )
        del x, y, yv, xv, ops, xc, yc
        if name == "h2o_cull_dvec":
            del mask
        torch.cuda.empty_cache()

    G5 = 64  # 10240 frames = 16 samples x 4 slots x 160, one cloud per frame
    x, y, yv, _, _ = kernel_inputs(R_ALL_PAIRS_P, G=G5, L=L, seed=7)
    yy = y.repeat_interleave(L, 0).contiguous()
    del y
    _, idx = NN.h2o_nn(x, yy, yv.repeat_interleave(L, 0), 1)
    xr = torch.randn(x.shape[:2], device="cuda")
    F, P1, _ = x.shape
    P2 = yy.shape[1]
    srt = torch.sort(idx, dim=1).values
    distinct = F + int((srt[:, 1:] != srt[:, :-1]).sum())  # the y rows the gather needs
    b5, by5 = bound_ms(x.numel() * 4 + F * P1 * 8 + distinct * 12 + F * P1 * 12 + F * P2 * 12, 0)
    gx, gy = HB.launch(x, yy, idx, xr, True, 1)
    px, py = HB.plain(x, yy, idx, xr, True, 1)
    require(torch.equal(gx, px) and scatter_close(gy, py),
            f"h2o_nn_bwd differs from the plain version at F={F} P2={P2}: gy {(gy - py).abs().max().item()}")
    err5 = max(err5, (gy - py).abs().max().item())
    print(f"h2o_nn_bwd F={F} P1={P1} P2={P2} y_group 1: gx equal, gy within 1e-5 per frame "
          f"(max abs err {(gy - py).abs().max().item()})", flush=True)
    del gx, gy, px, py
    out["h2o_nn_bwd"] = dict(
        kernel=HB.KERNEL, max_abs_err=err5, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: HB.launch(x, yy, idx, xr, True, 1), reps=10),
        plain_ms=cuda_time_ms(lambda: HB.plain(x, yy, idx, xr, True, 1), reps=3),
        library_ms=cuda_time_ms(lambda: library_h2o_bwd(x, yy, idx, xr), reps=3),
        bound_ms=b5, bound_by=by5,
    )
    for name in ("h2o_cull_dvec", "h2o_nn_dvec", "h2o_nn_bwd"):
        o = out[name]
        F, P1, P2 = o["shape"]
        rf = f" run_fraction={o['run_fraction']:.4f}" if "run_fraction" in o else ""
        print(f"{name} F={F} P1={P1} P2={P2}: ms={o['ms']:.4f} plain_ms={o['plain_ms']:.3f} "
              f"library_ms={o['library_ms']:.3f} bound_ms={o['bound_ms']:.4f} ({o['bound_by']}){rf}",
              flush=True)
    print("plain_ms of h2o_cull_dvec and h2o_nn_dvec: 8 x the time on 1/8 of the frames", flush=True)
    del x, yy, yv, idx, xr, srt
    torch.cuda.empty_cache()
    return out


R_KERNELS = ("h2o_nn", "h2o_cull", "h2o_nn_dvec", "h2o_cull_dvec", "h2o_nn_bwd")


def _r_kernel_objects() -> dict:
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_h2o_bwd as HB
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    return dict(zip(R_KERNELS, (NN.KERNEL, CU.KERNEL, NN.DVEC_KERNEL, CU.DVEC_KERNEL, HB.KERNEL)))


def _zero_counts(kernels: dict) -> None:
    for k in kernels.values():
        k.launches = 0


def _r_geometry(device):
    """(synthetic MANO of both hands, contact assets) on `device`."""
    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models

    mano = stack_mano_models(M.get_mano_model(None, "right"), M.get_mano_model(None, "left"), device)
    return mano, LL.load_contact_assets(device=device)


def _r_training(device, cfg, backend: str, seed: int = 0):
    """(state, step_fn, mano, assets) of an R train step on `device`, weights
    from `seed` (built on the CPU, then moved: the same on every device)."""
    import torch

    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.refine_r import SegmentRefineNet
    from oakink2_tamf_tpu_torch.parallel import train as PT

    torch.manual_seed(seed)
    net = SegmentRefineNet(cfg).to(device)
    state = PT.TrainState(net, PT.make_optimizer(net.named_parameters()))
    mano, assets = _r_geometry(device)
    step = PT.make_r_train_step(mano, assets, LL.RefineLossConfig(), backend=backend)
    return state, step, mano, assets


def _r_batch(bs: int, L: int, nobj: int, P: int, seed: int, mano, device, cache: bool = True):
    """A collated R batch on `device`: synthetic segments, the target-h2o
    cache precomputed on the device (when `cache`), and the Gaussian-perturb
    adaptor. -> (batch, precompute seconds)."""
    import torch

    from oakink2_tamf_tpu_torch.data.adaptors import GaussianPerturbSampleAdaptor
    from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
    from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
    from oakink2_tamf_tpu_torch.data.target_cache import TargetH2OCache
    from oakink2_tamf_tpu_torch.launch import common

    ds = SyntheticSegments(bs, seq_len=L, max_nobj=nobj, n_obj_points=P, seed=seed)
    collate = SegmentCollate(max_nobj=nobj, n_obj_points=P)
    pre = 0.0
    if cache:
        ds = TargetH2OCache(ds, mano, collate)
        t0 = time.perf_counter()
        ds.precompute()
        if device.type == "cuda":
            torch.cuda.synchronize()
        pre = time.perf_counter() - t0
    ds = GaussianPerturbSampleAdaptor(ds, seed=0)
    return common.device_batch(collate([ds[i] for i in range(bs)]), device), pre


def small_r_train_parity() -> None:
    """A small R train step on the GPU (kernels) and on the CPU (plain
    versions): the same weights and batch, dropout 0, on the culled route
    (forced) and the all-pairs route. Loss within rtol 1e-4; each
    parameter's clipped gradient within 2e-3 of its norm (+1e-6), as the G
    step is held."""
    import torch

    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig

    cfg = RefineConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
    kernels = _r_kernel_objects()
    for backend, used in (("cull", "h2o_cull_dvec"), ("auto", "h2o_nn_dvec")):
        res = {}
        for dev in ("cuda", "cpu"):
            state, step, mano, _ = _r_training(torch.device(dev), cfg, backend)
            db, _ = _r_batch(4, 16, 2, 512, 5, mano, torch.device(dev), cache=False)
            _zero_counts(kernels)
            m = step(state, db)
            counts = {n: k.launches for n, k in kernels.items()}
            if dev == "cuda":
                require(counts[used] == 1, f"small R step ({backend}): {used} launched {counts[used]} times")
            res[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in state.model.named_parameters()})
        la, lb = res["cuda"][0], res["cpu"][0]
        require(abs(la - lb) <= 1e-4 * abs(lb), f"R train step {backend}: GPU loss {la} vs CPU {lb}")
        worst = 0.0
        for k, gb in res["cpu"][1].items():
            dd = (res["cuda"][1][k] - gb).norm().item()
            require(dd <= 2e-3 * gb.norm().item() + 1e-6, f"R train step {backend}: grad {k} differs by {dd}")
            worst = max(worst, dd / (gb.norm().item() + 1e-12))
        print(f"small R train step ({backend}): GPU (kernels) vs CPU (plain) loss {la:.6f} / {lb:.6f}, "
              f"worst relative grad diff {worst:.2e}", flush=True)


def r_train_main_path():
    """R training at full width: arch_refine (dropout 0.1), batch 64 x 160
    frames x 4 objects x 8192 points, target_h2o from TargetH2OCache, sample
    from the Gaussian-perturb adaptor; one warm-up step, then 3 timed steps
    with the counts set to 0 just before; then the split of a step on the
    same batch."""
    import torch

    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.refine_r import (
        RefineConfig, batch_recover_mano, multi_object_h2o_dist, refine_forward, sample_geometry,
        target_geometry,
    )

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state, step, mano, assets = _r_training(dev, RefineConfig(), "auto")
    db, pre = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, TRAIN_P, 11, mano, dev)
    torch.cuda.synchronize()
    print(f"R main path: model + batch {time.perf_counter() - t0:.2f} s, of which the target-h2o cache "
          f"precompute ({TRAIN_BS} segments on the card) {pre:.3f} s "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)", flush=True)
    t0 = time.perf_counter()
    step(state, db)
    torch.cuda.synchronize()
    print(f"R main path: warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

    before = [p.detach().clone() for p in state.model.parameters()]
    kernels = _r_kernel_objects()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        m = step(state, db)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    counts = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = sum(times) / len(times)
    print(f"R main path (cull route): steps {[round(t, 4) for t in times]} s, mean {step_s:.4f} s = "
          f"{TRAIN_BS / step_s:.3f} samples/s; losses {losses}; peak memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    require(all(v == v and abs(v) < float("inf") for v in losses), "R: non-finite training loss")
    require(any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters())), "R: parameters unchanged")
    require(counts["h2o_cull"] == 3, f"R: h2o_cull (sample geometry) launched {counts['h2o_cull']} times in 3 steps")
    require(counts["h2o_cull_dvec"] == 3, f"R: h2o_cull_dvec launched {counts['h2o_cull_dvec']} times in 3 steps")
    del before

    # where the step's time goes, each piece alone on the same batch
    net, mask = state.model, db["mask"]
    cond = {k: db[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    with torch.no_grad():
        sg = sample_geometry(mano, db, frame_mask=mask)
        res = refine_forward(net, mano, db, with_target=False, sample_geom=sg, loss_frame_mask=mask)
        tgt = target_geometry(mano, db, frame_mask=mask)

    with torch.no_grad():
        s_verts = batch_recover_mano(mano, db["sample_pose_repr"], db["shape"], db["hand_side"])[0]
    r_pose = res["refine_pose_repr"].detach()
    with torch.no_grad():
        r_verts = batch_recover_mano(mano, r_pose, db["shape"], db["hand_side"])[0]

    def sample_mano():
        with torch.no_grad():
            batch_recover_mano(mano, db["sample_pose_repr"], db["shape"], db["hand_side"])

    def sample_h2o():
        with torch.no_grad():
            multi_object_h2o_dist(s_verts, db["obj_traj"], db["obj_points"], db["obj_mask"],
                                  x_perm=mano.template_perm, frame_mask=mask)

    def r_fwd_bwd():
        net.zero_grad(set_to_none=True)
        net(db["sample_pose_repr"], sg["sample_h2o_dist"], cond).square().mean().backward()

    def refined_mano():
        v, j, _ = batch_recover_mano(mano, r_pose.clone().requires_grad_(True), db["shape"], db["hand_side"])
        (v.sum() + j.sum()).backward()

    def refined_h2o():
        h = multi_object_h2o_dist(r_verts.clone().requires_grad_(True), db["obj_traj"], db["obj_points"],
                                  db["obj_mask"], x_perm=mano.template_perm, frame_mask=mask)
        (h * mask[:, :, None]).sum().backward()

    def loss_pass():
        o = {k: res[k].detach().requires_grad_(True) for k in
             ("refine_hand_joints", "refine_hand_verts", "refine_h2o_dist")}
        LL.segment_refine_loss(assets, LL.RefineLossConfig(), {**o, **tgt}, db)[0].backward()

    split = {
        "sample MANO with normals (no grad)": cuda_time_ms(sample_mano, reps=3),
        "sample h2o (cull mask + h2o_cull, no grad)": cuda_time_ms(sample_h2o, reps=3),
        "R forward+backward": cuda_time_ms(r_fwd_bwd, reps=3),
        "refined MANO with normals forward+backward": cuda_time_ms(refined_mano, reps=3),
        "refined h2o (cull mask + h2o_cull_dvec) forward+backward": cuda_time_ms(refined_h2o, reps=3),
        "loss forward+backward": cuda_time_ms(loss_pass, reps=3),
        "optimizer (clip + AdamW + LR)": cuda_time_ms(state.optimizer.step, reps=3),
    }
    print("R step split (ms, each alone on the same batch): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    del db, sg, res, tgt, s_verts, r_verts, r_pose
    torch.cuda.empty_cache()
    return state, counts, step_s


def r_all_pairs_route(state):
    """The same model on a 2048-point batch (the repo default cloud), 2
    steps: the all-pairs kernels run, #4 in the refined branch."""
    import torch

    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.parallel import train as PT

    dev = torch.device("cuda")
    mano, assets = _r_geometry(dev)
    step = PT.make_r_train_step(mano, assets, LL.RefineLossConfig())
    db, _ = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, R_ALL_PAIRS_P, 12, mano, dev)
    kernels = _r_kernel_objects()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    times, losses = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        m = step(state, db)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    counts = {n: k.launches for n, k in kernels.items()}
    print(f"R all-pairs route ({R_ALL_PAIRS_P} points): steps {[round(t, 4) for t in times]} s; losses {losses}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}", flush=True)
    require(all(v == v and abs(v) < float("inf") for v in losses), "R all-pairs: non-finite loss")
    require(counts["h2o_nn_dvec"] == 2, f"R all-pairs: h2o_nn_dvec launched {counts['h2o_nn_dvec']} times")
    require(counts["h2o_cull"] == 0 and counts["h2o_cull_dvec"] == 0, "R all-pairs: a culled kernel launched")
    return counts


def r_entry_point() -> None:
    """launch/train_r.main on the synthetic smoke config, on the card."""
    import torch

    from oakink2_tamf_tpu_torch.launch import train_r

    root = os.path.dirname(os.path.abspath(__file__))
    kernels = _r_kernel_objects()
    _zero_counts(kernels)
    t0 = time.perf_counter()
    state = train_r.main(["--cfg", os.path.join(root, "config/synthetic_smoke.yml"), "--exp_id", "chip_smoke_r"])
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items()}
    require(state.step == 4, f"train_r.main took {state.step} steps, expected 4")
    require(all(torch.isfinite(p).all() for p in state.model.parameters()), "train_r.main: non-finite weights")
    require(next(state.model.parameters()).is_cuda, "train_r.main did not run on the card")
    print(f"train_r.main (synthetic_smoke.yml, cuda): 2 epochs, {state.step} steps in "
          f"{time.perf_counter() - t0:.2f} s; launches {counts}", flush=True)
    require(counts["h2o_nn_dvec"] == 4, "train_r.main did not run the refined branch's kernel")


def grad_y_path():
    """Autograd through point2point_h2o(grad_y=True) on the GPU (#1 forward,
    #5 backward) and on the CPU (plain versions), 4 frames x 778 rows x
    2048 points with a ragged and an all-invalid cloud. Each device centres
    a cloud on its own mean, summed in another order; the coordinates lie
    on a 2^-12 grid, where those sums are exact. What may remain is the
    plain version's rare double rounding (float64 fma emulation): distances
    within rtol 1e-6 + 5e-8 m (an ulp of the 0.1 m-scale centred
    coordinates); on rows whose argmin agrees (at least 99.9%) gx within
    rtol 1e-4 / atol 1e-6; on frames whose argmins all agree gy within 1e-4
    of the frame's norm."""
    import torch

    from oakink2_tamf_tpu_torch.core import geometry as G
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    x, y, yv, _, _ = kernel_inputs(R_ALL_PAIRS_P, G=4, L=1, seed=8)
    x, y = (torch.round(t * 4096) / 4096 for t in (x, y))
    w = torch.randn(4, 778, device="cuda")
    kernels = _r_kernel_objects()
    res = {}
    counts = {}
    for dev in ("cuda", "cpu"):
        xt = x.to(dev).clone().requires_grad_(True)
        yt = y.to(dev).clone().requires_grad_(True)
        _zero_counts(kernels)
        d = G.point2point_h2o(xt, yt, yv.to(dev), grad_y=True)
        (w.to(dev) * d).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = {n: k.launches for n, k in kernels.items()}
        res[dev] = (d.detach().cpu(), xt.grad.cpu(), yt.grad.cpu())
    require(counts["h2o_nn"] == 1 and counts["h2o_nn_bwd"] == 1, "grad_y path: #1 and #5 did not both launch")
    (da, gxa, gya), (db, gxb, gyb) = res["cuda"], res["cpu"]
    same = NN.h2o_nn(x, y, yv, 1)[1].cpu() == NN.h2o_nn(x.cpu(), y.cpu(), yv.cpu(), 1)[1]
    frames = same.all(dim=1)
    d_err = (da - db).abs().max().item()
    print(f"grad_y path: distances differ on {int((da != db).sum())} of {da.numel()} rows (max abs "
          f"{d_err}); argmins differ on {int((~same).sum())} rows", flush=True)
    require(torch.allclose(da, db, rtol=1e-6, atol=5e-8), f"grad_y path: distances differ by {d_err}")
    require(same.float().mean().item() >= 0.999, "grad_y path: argmins differ on more than 0.1% of the rows")
    require(torch.allclose(gxa[same], gxb[same], rtol=1e-4, atol=1e-6),
            f"grad_y path: gx differs by {(gxa - gxb)[same].abs().max().item()}")
    require(bool(frames.any()) and scatter_close(gya[frames], gyb[frames], rtol=1e-4),
            f"grad_y path: gy differs by {(gya - gyb)[frames].abs().max().item()}")
    print(f"grad_y path: GPU matches CPU (gy max abs err {(gya - gyb)[frames].abs().max().item()} over "
          f"{int(frames.sum())} frames); launches {counts}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# The cluster route: kernels #10-#13, R train-step parity, the R main path,
# the signed entry point, train_r.main with the certificate
# ---------------------------------------------------------------------------

CLUSTER_KERNELS = ("h2o_topk", "h2o_topk_bwd", "o2h_topk", "o2h_topk_bwd")


def _cluster_kernel_objects() -> dict:
    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC

    return dict(zip(CLUSTER_KERNELS, CC.KERNELS))


def cluster_operands(seed: int):
    """The R main path's h2o operands at full width: the sample hand of a
    synthetic batch (64 samples x 160 frames, 4 object slots, 8192 points)
    moved into each object's canonical frame -> (x [40960, 778, 3],
    y [256, 8192, 3], y_valid [256, 8192] (padded slots all-invalid), the
    template permutation, normals [40960, 778, 3])."""
    import torch

    from oakink2_tamf_tpu_torch.core import transforms as T
    from oakink2_tamf_tpu_torch.models import refine_r as R

    dev = torch.device("cuda")
    mano, _ = _r_geometry(dev)
    db, _ = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, TRAIN_P, seed, mano, dev, cache=False)
    with torch.no_grad():
        verts, _, normals = R.batch_recover_mano(mano, db["sample_pose_repr"], db["shape"], db["hand_side"])
        x, y = R._canonical_frame_operands(verts, db["obj_traj"], db["obj_points"])
        rot = T.tslrot6d_to_transf(db["obj_traj"])[..., :3, :3]  # the normals turn with the hand
        n = torch.einsum("bolck,blvc->bolvk", rot, normals).reshape(x.shape)
    yv = db["obj_mask"].reshape(-1, 1).expand(-1, TRAIN_P).contiguous()
    return x.contiguous(), y.contiguous(), yv, mano.template_perm, n.contiguous()


def library_min_idx(xc, yc, groups: int = 4):
    """#10/#12's library yardstick: torch.cdist(x, y).min(-1) (values and
    indices) over `groups` clouds per call."""
    import torch

    return [torch.cdist(xc[g : g + groups], yc[g : g + groups]).min(-1) for g in range(0, xc.shape[0], groups)]


def library_gather(x, y, idx, xr, y_group: int):
    """#11's yardstick without grad_y: a gather of each row's point, times
    the cotangent row."""
    import torch

    F, P1, _ = x.shape
    P2 = y.shape[1]
    flat = ((torch.arange(F, device=x.device) // y_group)[:, None] * P2 + idx.long()).reshape(-1)
    return xr[..., None] * (x - y.reshape(-1, 3)[flat].reshape(F, P1, 3))


def library_o2h_bwd(x, y, o2h_i, yc):
    """#13's yardstick: a gather of each point's row, then index_add_ into
    gx (one cloud per frame)."""
    import torch

    F, P1, _ = x.shape
    flat = (torch.arange(F, device=x.device)[:, None] * P1 + o2h_i.long()).reshape(-1)
    u = yc[..., None] * (y - x.reshape(-1, 3)[flat].reshape(y.shape))
    return torch.zeros((F * P1, 3), device=x.device).index_add_(0, flat, -u.reshape(-1, 3)), u


def check_cluster_kernels() -> dict[str, dict]:
    """#10 h2o_topk, #11 h2o_topk_bwd, #12 o2h_topk and #13 o2h_topk_bwd on
    the R main path's own operands (sample hands in the canonical frames of
    a full-width synthetic batch, template permutation, padded slots
    all-invalid):
    - #10 against its plain version on the 5120 frames (y_group 160) its
      plain version is timed on: values and indices equal; against #1 on
      all 40960 frames: equal on rows of tiles whose certificate is clear,
      never below elsewhere (the overflowed-tile share is reported);
    - #11 without grad_y at y_group 160 (gx equal to the plain version) and
      with grad_y at 10240 frames x 778 x 2048 per-frame clouds (gx equal,
      gy within 1e-5 per frame);
    - #12 and #13 on 640 frames x 778 x 8192 per-frame clouds at k_tiles 0
      and 4: #12 equal to its plain version, and at k_tiles 0 to #6's o2h
      half; #13's gx within 1e-6 of its terms' magnitudes per frame
      (scatter_mass_close), gy equal;
    - each timed at the R training shape, 40960 frames x 778 rows x 8192
      points (y_group 160 for #10/#11, per-frame clouds for #12/#13), with
      the selection stage, the plain versions on 1/8 of the frames (x 8)
      and the library yardsticks."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_h2o_bwd as HB
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    out = {}
    L = TRAIN_L
    x, y, yv, perm, nrm = cluster_operands(seed=13)
    F, P1, _ = x.shape
    G, P2 = y.shape[:2]
    part = (F // 8, G // 8)
    xp, xs, y4, ctr = CC._prepare(x, y, yv, L, perm)

    def select():
        return CC.h2o_candidates(x, y, yv, x_perm=perm, y_group=L)

    cidx, ovf = select()
    T, K = cidx.shape[1:]
    d, idx = CC.launch_h2o_topk(xs, y4, ctr, cidx, L)
    torch.cuda.synchronize()
    (dp, ip), plain10_ms = cuda_timed(
        lambda: CC.plain_h2o_topk(xs[: part[0]], y4[: part[1]], ctr[: part[1]], cidx[: part[0]], L))
    require(torch.equal(d[: part[0]], dp) and torch.equal(idx[: part[0]], ip),
            f"h2o_topk differs from its plain version at F={part[0]} P2={P2} y_group={L}")
    err10 = (d[: part[0]] - dp).abs().max().item()
    del dp, ip
    da, _ = NN.launch(xs, y4, ctr, L)
    clear = ~ovf[:, torch.arange(P1, device=x.device) // CC.S_CELL]  # rows of certified tiles
    require(torch.equal(d[clear], da[clear]), "h2o_topk and h2o_nn differ on rows of certified tiles")
    require(bool((d >= da).all()), "h2o_topk is below the exact minimum somewhere")
    share = ovf.float().mean().item()
    over = d[~clear] - da[~clear]
    print(f"h2o_topk F={F} P1={P1} P2={P2} y_group={L} K={K}: equal to plain on {part[0]} frames "
          f"(max abs err {err10}); equal to h2o_nn on rows of certified tiles, never below; overflowed "
          f"tiles {int(ovf.sum())} of {ovf.numel()} ({share:.4f}), rows above the exact value "
          f"{int((over > 0).sum())} (max {over.max().item() if over.numel() else 0.0} m^2)", flush=True)
    del da, clear, over
    # the work this run's data needs: each tile's real rows against the valid
    # points of its candidate cells (a padded slot's cells hold none), the
    # operands of frames whose cloud has a valid point, every output row
    S = CC.S_CELL
    cell_pts = torch.nn.functional.pad(yv, (0, -(-P2 // S) * S - P2), value=False).reshape(G, -1, S).sum(-1)
    tile_rows = (P1 - S * torch.arange(T, device=x.device)).clamp(max=S)
    cloud = torch.arange(F, device=x.device) // L
    pairs10 = float((cell_pts[cloud[:, None, None], cidx.long()] * tile_rows[:, None]).sum())
    live_f = int(yv.any(1)[cloud].sum())
    b10, by10 = bound_ms(live_f * (P1 * 12 + T * K * 4) + int(yv.sum()) * 16 + F * P1 * 8, pairs10)
    print(f"h2o_topk bound: {pairs10:.6g} pairs on {live_f} of {F} frames with a real object", flush=True)
    del cell_pts, cloud
    xc = NN.centred_x(xs, ctr, L).reshape(G, L * P1, 3)
    yc = y4[..., :3].contiguous()
    out["h2o_topk"] = dict(
        kernel=CC.H2O_KERNEL, max_abs_err=err10, shape=[F, P1, P2], K=K, overflow_share=share,
        ms=cuda_time_ms(lambda: CC.launch_h2o_topk(xs, y4, ctr, cidx, L), reps=5),
        plain_ms=8 * plain10_ms,
        library_ms=cuda_time_ms(lambda: library_min_idx(xc, yc), reps=1),
        selection_ms=cuda_time_ms(select, reps=3),
        bound_ms=b10, bound_by=by10,
    )
    del xc, yc

    # --- #11: nogy at the main path's shape, grad_y on per-frame clouds ----
    ii = xp.unapply(idx)  # the caller's row order, as the autograd.Function saves it
    xr = torch.randn(F, P1, device="cuda")
    xr[:, ::7] = 0.0
    gx, _ = CC.h2o_topk_backward(x, y, ii, xr, False, L)
    px, _ = HB.plain(x, y, ii, xr, False, L)
    require(torch.equal(gx, px), f"h2o_topk_bwd (nogy, y_group {L}) differs from its plain version")
    del gx, px
    xg, yg, yvg, _, _ = kernel_inputs(R_ALL_PAIRS_P, G=64, L=L, seed=14)
    yg, yvg = yg.repeat_interleave(L, 0).contiguous(), yvg.repeat_interleave(L, 0)
    _, ig = CC.h2o_cluster_forward(xg, yg, yvg)
    xrg = torch.randn(xg.shape[:2], device="cuda")
    gx, gy = CC.h2o_topk_backward(xg, yg, ig, xrg, True, 1)
    px, py = HB.plain(xg, yg, ig, xrg, True, 1)
    require(torch.equal(gx, px) and scatter_close(gy, py),
            f"h2o_topk_bwd (grad_y) differs from its plain version: gy {(gy - py).abs().max().item()}")
    err11 = (gy - py).abs().max().item()
    print(f"h2o_topk_bwd nogy (F={F}, y_group {L}): gx equal to plain; grad_y (F={xg.shape[0]}, "
          f"P2={R_ALL_PAIRS_P}): gx equal, gy within 1e-5 per frame (max abs err {err11})", flush=True)
    del xg, yg, yvg, ig, xrg, gx, gy, px, py
    # rows with a nonzero cotangent read x and their index and gather a y
    # row (each distinct row once); every cotangent is read, every gx written
    live = xr != 0
    rows = torch.unique(((torch.arange(F, device=x.device) // L)[:, None] * P2 + ii.long())[live]).numel()
    b11, by11 = bound_ms(F * P1 * 4 + int(live.sum()) * 16 + rows * 12 + F * P1 * 12, 0)
    del live
    out["h2o_topk_bwd"] = dict(
        kernel=CC.H2O_BWD_KERNEL, max_abs_err=err11, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: CC.h2o_topk_backward(x, y, ii, xr, False, L), reps=10),
        plain_ms=cuda_time_ms(lambda: HB.plain(x, y, ii, xr, False, L), reps=3),
        library_ms=cuda_time_ms(lambda: library_gather(x, y, ii, xr, L), reps=3),
        bound_ms=b11, bound_by=by11,
    )
    del d, idx, ii, xr, cidx, ovf, xs, y4, ctr
    torch.cuda.empty_cache()

    # --- #12 / #13 on 640 frames with per-frame clouds, k_tiles 0 and 4 ----
    f6 = 4 * L
    x6, n6 = x[:f6].contiguous(), nrm[:f6].contiguous()
    y6, yv6 = y[:4].repeat_interleave(L, 0).contiguous(), yv[:4].repeat_interleave(L, 0)
    xp6, xs6, y46, ctr6 = CC._prepare(x6, y6, yv6, 1, perm)
    ns6 = xp6.apply(n6).contiguous()
    xc6, xv6, yc6, yvp6 = CC.selection_operands(xs6, y6, yv6, ctr6, 1)
    err12 = err13 = 0.0
    for kt in (0, 4):
        cidx_y, ovf_y = CC._o2h_candidates(xc6, xv6, yc6, yvp6, kt)
        got = CC.launch_o2h_topk(xs6, ns6, y46, ctr6, cidx_y)
        torch.cuda.synchronize()
        want = CC.plain_o2h_topk(xs6, ns6, y46, ctr6, cidx_y)
        for nm, a, b in zip(("o2h_d", "o2h_i", "o2h_dot"), got, want):
            require(torch.equal(a, b), f"o2h_topk {nm} (k_tiles {kt}) differs from its plain version")
        err12 = max(err12, *((a - b).abs().max().item() for a, b in zip(got[::2], want[::2])))
        if kt == 0:
            sig = CS.launch(xs6, ns6, y46, ctr6, 1)
            for nm, a, b in zip(("o2h_d", "o2h_i", "o2h_dot"), got, sig[2:]):
                require(torch.equal(a, b), f"o2h_topk {nm} at k_tiles 0 differs from nn_signed's o2h half")
            del sig
        o2h_i = xp6.to_original(torch.clamp(got[1], 0, P1 - 1)).to(torch.int32)
        ycot = torch.randn(f6, P2, device="cuda") * yv6
        mass = o2h_mass(x6, y6, o2h_i, ycot)
        for grad_y in (False, True):
            gx, gy = CC.launch_o2h_backward(x6, y6, o2h_i, ycot, grad_y)
            px, py = CC.plain_o2h_backward(x6, y6, o2h_i, ycot, grad_y)
            d = (gx - px).flatten(1).norm(dim=1)
            rel = (d / (px.flatten(1).norm(dim=1) + 1e-12)).max().item()
            rel_mass = (d / (mass.flatten(1).norm(dim=1) + 1e-12)).max().item()
            require(scatter_mass_close(gx, px, mass), f"o2h_topk_bwd gx (k_tiles {kt}, grad_y {grad_y}) vs plain: "
                    f"worst frame {rel:.3e} of its norm, {rel_mass:.3e} of its terms' magnitudes")
            require(not grad_y or torch.equal(gy, py), f"o2h_topk_bwd gy (k_tiles {kt}) differs from plain")
            err13 = max(err13, (gx - px).abs().max().item())
        print(f"o2h_topk / o2h_topk_bwd F={f6} P1={P1} P2={P2} k_tiles={kt} (o2h overflow "
              f"{int(ovf_y.sum())} of {ovf_y.numel()} cells): #12 equal to plain"
              + (" and to nn_signed's o2h half" if kt == 0 else "")
              + f"; #13 gx within 1e-6 of its terms' magnitudes per frame (max abs err {err13}; worst frame "
              f"{rel:.3e} of its norm, {rel_mass:.3e} of the magnitudes), gy equal", flush=True)
    del x6, n6, y6, yv6, xs6, y46, ctr6, ns6, xc6, xv6, yc6, yvp6, got, want, gx, gy, px, py, ycot
    torch.cuda.empty_cache()

    # --- #12 / #13 timed at the R training shape, per-frame clouds --------
    yF, yvF = y.repeat_interleave(L, 0).contiguous(), yv.repeat_interleave(L, 0)
    xpF, xsF, y4F, ctrF = CC._prepare(x, yF, yvF, 1, perm)
    nsF = xpF.apply(nrm).contiguous()
    # the work this run's data needs: the valid points against the 778 rows,
    # the operands of frames whose cloud has a valid point, every output
    n_valid, live_f = int(yvF.sum()), int(yvF.any(1).sum())
    del yvF
    C = y4F.shape[1] // CC.S_CELL
    cidx_y = torch.arange(T, dtype=torch.int32, device=x.device).expand(F, C, T).contiguous()
    o2h = CC.launch_o2h_topk(xsF, nsF, y4F, ctrF, cidx_y)
    sl = slice(0, part[0])
    want, plain12_ms = cuda_timed(lambda: CC.plain_o2h_topk(xsF[sl], nsF[sl], y4F[sl], ctrF[sl], cidx_y[sl]))
    for nm, a, b in zip(("o2h_d", "o2h_i", "o2h_dot"), o2h, want):
        require(torch.equal(a[sl], b), f"o2h_topk {nm} differs from its plain version at F={part[0]} P2={P2}")
    del want
    b12, by12 = bound_ms(live_f * (P1 * 24 + C * T * 4) + n_valid * 16 + F * P2 * 12, float(n_valid * P1))
    print(f"o2h_topk bound: {n_valid * P1:.6g} pairs, {n_valid} valid points on {live_f} of {F} frames",
          flush=True)
    xcF = NN.centred_x(xsF, ctrF, 1)
    ycF = y4F[..., :3]
    out["o2h_topk"] = dict(
        kernel=CC.O2H_KERNEL, max_abs_err=err12, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: CC.launch_o2h_topk(xsF, nsF, y4F, ctrF, cidx_y), reps=3),
        plain_ms=8 * plain12_ms,
        library_ms=cuda_time_ms(lambda: library_min_idx(ycF, xcF, groups=256), reps=1),
        bound_ms=b12, bound_by=by12,
    )
    del xcF, ycF, xsF, nsF, y4F, ctrF, cidx_y
    o2h_i = xpF.to_original(torch.clamp(o2h[1], 0, P1 - 1)).to(torch.int32)
    del o2h
    torch.cuda.empty_cache()
    ycot = torch.randn(F, P2, device="cuda") * yv.repeat_interleave(L, 0)
    # points with a nonzero cotangent (the valid ones) read y and their index
    # and gather an x row (each distinct row once); every cotangent is read,
    # every gx written
    live = ycot != 0
    srt = torch.sort(torch.where(live, o2h_i, P1), dim=1).values  # P1 marks a point without work
    rows = int((srt[:, 0] != P1).sum()) + int(((srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] != P1)).sum())
    n_live = int(live.sum())
    del srt, live
    b13, by13 = bound_ms(F * P2 * 4 + n_live * 16 + rows * 12 + F * P1 * 12, 0)
    out["o2h_topk_bwd"] = dict(
        kernel=CC.O2H_BWD_KERNEL, max_abs_err=err13, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: CC.launch_o2h_backward(x, yF, o2h_i, ycot, False), reps=5),
        plain_ms=cuda_time_ms(lambda: CC.plain_o2h_backward(x, yF, o2h_i, ycot, False), reps=1),
        library_ms=cuda_time_ms(lambda: library_o2h_bwd(x, yF, o2h_i, ycot), reps=1),
        bound_ms=b13, bound_by=by13,
    )
    for name in CLUSTER_KERNELS:
        o = out[name]
        extra = f" selection_ms={o['selection_ms']:.3f}" if "selection_ms" in o else ""
        print(f"{name} F={F} P1={P1} P2={P2}: ms={o['ms']:.4f} plain_ms={o['plain_ms']:.3f} "
              f"library_ms={o['library_ms']:.3f} bound_ms={o['bound_ms']:.4f} ({o['bound_by']}){extra}",
              flush=True)
    print("plain_ms of h2o_topk and o2h_topk: 8 x the time on 1/8 of the frames", flush=True)
    del x, y, yv, nrm, yF, o2h_i, ycot
    torch.cuda.empty_cache()
    return out


def small_r_cluster_parity() -> None:
    """A small R train step on the cluster route, GPU (kernels #10, #11)
    against CPU (plain versions), as small_r_train_parity holds the other
    routes: loss rtol 1e-4, each gradient within 2e-3 of its norm."""
    import torch

    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig

    cfg = RefineConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
    kernels = {**_r_kernel_objects(), **_cluster_kernel_objects()}
    res = {}
    for dev in ("cuda", "cpu"):
        state, step, mano, _ = _r_training(torch.device(dev), cfg, "cluster")
        db, _ = _r_batch(4, 16, 2, 512, 5, mano, torch.device(dev), cache=False)
        _zero_counts(kernels)
        m = step(state, db)
        if dev == "cuda":
            counts = {n: k.launches for n, k in kernels.items()}
            require(counts["h2o_topk"] == 3 and counts["h2o_topk_bwd"] == 1,
                    f"small R step (cluster): launches {counts}")
            require(all(counts[n] == 0 for n in R_KERNELS), f"small R step (cluster): an exact kernel ran {counts}")
        res[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in state.model.named_parameters()})
    la, lb = res["cuda"][0], res["cpu"][0]
    require(abs(la - lb) <= 1e-4 * abs(lb), f"R train step cluster: GPU loss {la} vs CPU {lb}")
    worst = 0.0
    for k, gb in res["cpu"][1].items():
        dd = (res["cuda"][1][k] - gb).norm().item()
        require(dd <= 2e-3 * gb.norm().item() + 1e-6, f"R train step cluster: grad {k} differs by {dd}")
        worst = max(worst, dd / (gb.norm().item() + 1e-12))
    print(f"small R train step (cluster): GPU (kernels) vs CPU (plain) loss {la:.6f} / {lb:.6f}, "
          f"worst relative grad diff {worst:.2e}", flush=True)


def r_cluster_main_path():
    """R training at full width on the cluster route (train.h2o_backend
    cluster): arch_refine (dropout 0.1), batch 64 x 160 frames x 4 objects
    x 8192 points, target_h2o from TargetH2OCache, the Gaussian-perturb
    adaptor; one warm-up step, then 3 timed steps with the counts set to 0
    just before; the step's split on the same batch; the val probe's
    overflow count on the batch."""
    import torch

    from oakink2_tamf_tpu_torch.launch import train_r
    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models import refine_r as R
    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state, step, mano, assets = _r_training(dev, R.RefineConfig(), "cluster")
    db, pre = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, TRAIN_P, 11, mano, dev)
    torch.cuda.synchronize()
    print(f"R cluster main path: model + batch {time.perf_counter() - t0:.2f} s (cache precompute "
          f"{pre:.3f} s)", flush=True)
    t0 = time.perf_counter()
    step(state, db)
    torch.cuda.synchronize()
    print(f"R cluster main path: warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

    before = [p.detach().clone() for p in state.model.parameters()]
    kernels = {**_r_kernel_objects(), **_cluster_kernel_objects()}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(kernels)
    times, losses = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        m = step(state, db)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    counts = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = sum(times) / len(times)
    print(f"R main path (cluster route): steps {[round(t, 4) for t in times]} s, mean {step_s:.4f} s = "
          f"{TRAIN_BS / step_s:.3f} samples/s; losses {losses}; peak memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    require(all(v == v and abs(v) < float("inf") for v in losses), "R cluster: non-finite training loss")
    require(any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters())),
            "R cluster: parameters unchanged")
    require(counts["h2o_topk"] == 6, f"R cluster: h2o_topk launched {counts['h2o_topk']} times in 3 steps")
    require(counts["h2o_topk_bwd"] == 3, f"R cluster: h2o_topk_bwd launched {counts['h2o_topk_bwd']} times")
    require(all(counts[n] == 0 for n in R_KERNELS), f"R cluster: an exact h2o kernel launched: {counts}")
    del before

    # where the step's time goes, each piece alone on the same batch
    net, mask, perm = state.model, db["mask"], mano.template_perm
    cond = {k: db[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    with torch.no_grad():
        sg = R.sample_geometry(mano, db, frame_mask=mask, backend="cluster")
        res = R.refine_forward(net, mano, db, with_target=False, sample_geom=sg, loss_frame_mask=mask,
                               backend="cluster")
        s_verts = sg["sample_hand_verts"]
        r_verts = res["refine_hand_verts"]
        x, y = R._canonical_frame_operands(s_verts, db["obj_traj"], db["obj_points"])
        yv = db["obj_mask"].reshape(-1, 1).expand(-1, TRAIN_P)
        xp, xs, y4, ctr = CC._prepare(x, y, yv, TRAIN_L, perm)
        cidx, _ = CC.h2o_candidates(x, y, yv, x_perm=perm, y_group=TRAIN_L)
        _, idx = CC.h2o_cluster_forward(x, y, yv, x_perm=perm, y_group=TRAIN_L)
    r_pose = res["refine_pose_repr"].detach()
    xr = torch.randn(x.shape[:2], device=dev)

    def sample_mano():
        with torch.no_grad():
            R.batch_recover_mano(mano, db["sample_pose_repr"], db["shape"], db["hand_side"])

    def sample_h2o():
        with torch.no_grad():
            R.multi_object_h2o_dist(s_verts, db["obj_traj"], db["obj_points"], db["obj_mask"],
                                    x_perm=perm, frame_mask=mask, backend="cluster")

    def r_fwd_bwd():
        net.zero_grad(set_to_none=True)
        net(db["sample_pose_repr"], sg["sample_h2o_dist"], cond).square().mean().backward()

    def refined_mano():
        v, j, _ = R.batch_recover_mano(mano, r_pose.clone().requires_grad_(True), db["shape"], db["hand_side"])
        (v.sum() + j.sum()).backward()

    def refined_h2o():
        h = R.multi_object_h2o_dist(r_verts.clone().requires_grad_(True), db["obj_traj"], db["obj_points"],
                                    db["obj_mask"], x_perm=perm, frame_mask=mask, backend="cluster")
        (h * mask[:, :, None]).sum().backward()

    split = {
        "sample MANO with normals (no grad)": cuda_time_ms(sample_mano, reps=3),
        "sample h2o (selection + h2o_topk, no grad)": cuda_time_ms(sample_h2o, reps=3),
        "selection stage alone (runs twice per step)": cuda_time_ms(
            lambda: CC.h2o_candidates(x, y, yv, x_perm=perm, y_group=TRAIN_L), reps=3),
        "h2o_topk alone (runs twice per step)": cuda_time_ms(
            lambda: CC.launch_h2o_topk(xs, y4, ctr, cidx, TRAIN_L), reps=5),
        "R forward+backward": cuda_time_ms(r_fwd_bwd, reps=3),
        "refined MANO with normals forward+backward": cuda_time_ms(refined_mano, reps=3),
        "refined h2o (selection + h2o_topk + h2o_topk_bwd) forward+backward": cuda_time_ms(refined_h2o, reps=3),
        "h2o_topk_bwd alone": cuda_time_ms(
            lambda: CC.h2o_topk_backward(x, y, idx, xr, False, TRAIN_L), reps=10),
        "optimizer (clip + AdamW + LR)": cuda_time_ms(state.optimizer.step, reps=3),
    }
    print("R cluster step split (ms, each alone on the same batch): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    probe = train_r.make_overflow_probe(mano, backend="cluster")
    count = int(probe(db))
    tiles = int(db["obj_mask"].sum()) * TRAIN_L * cidx.shape[1]
    print(f"R cluster main path: val probe on the batch: {count} overflowed x tiles of {tiles} "
          f"({count / max(tiles, 1):.4f}) in the real object slots", flush=True)
    del db, sg, res, s_verts, r_verts, r_pose, x, y, yv, xs, y4, ctr, cidx, idx, xr
    torch.cuda.empty_cache()
    return counts, step_s


def signed_cluster_entry_point():
    """core/geometry.point2point_signed(backend="cluster") under autograd on
    640 frames x 778 x 8192 per-frame clouds of the main path's operands
    (normals, grad_y False), the counts set to 0 just before: #10 and #12
    forward, #11 and #13 backward, once each. Against the exact signed pair
    (#6/#7) on the same operands: y2x equal (k_tiles 0 searches every
    tile); x2y equal and gx within 1e-6 of its terms' magnitudes
    (scatter_mass_close) on frames whose h2o certificate is clear."""
    import torch

    from oakink2_tamf_tpu_torch.core import geometry as TG
    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    x, y, yv, perm, nrm = cluster_operands(seed=15)
    f6 = 4 * TRAIN_L
    x, nrm = x[:f6].contiguous(), nrm[:f6].contiguous()
    y, yv = y[:4].repeat_interleave(TRAIN_L, 0).contiguous(), yv[:4].repeat_interleave(TRAIN_L, 0)
    rng = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(y.shape[:2], device="cuda", generator=rng)
    b = torch.randn(x.shape[:2], device="cuda", generator=rng)
    kernels = _cluster_kernel_objects()
    res = {}
    for backend in ("cluster", "auto"):
        xt = x.clone().requires_grad_(True)
        if backend == "cluster":
            _zero_counts(kernels)
        y2x, x2y, _ = TG.point2point_signed(xt, y, nrm, yv, backend=backend, x_perm=perm, grad_y=False)
        ((a * y2x).sum() + (b * x2y).sum()).backward()
        torch.cuda.synchronize()
        if backend == "cluster":
            counts = {n: k.launches for n, k in kernels.items()}
        res[backend] = (y2x.detach(), x2y.detach(), xt.grad)
    require(all(v == 1 for v in counts.values()), f"signed cluster entry point: launches {counts}")
    ovf_h, ovf_o = CC.signed_cluster_overflow(x, y, yv, x_perm=perm)
    ok = ovf_h == 0
    (cy, cx, cg), (ey, ex, eg) = res["cluster"], res["auto"]
    require(torch.equal(cy, ey), "signed cluster: y2x differs from the exact signed pair")
    require(bool(ok.any()) and torch.equal(cx[ok], ex[ok]), "signed cluster: x2y differs on certified frames")
    # the o2h side's terms: cotangent a times sign over y2x (the exact pair's indices)
    o2h_i = CS.nn_signed(x, y, nrm, yv, 1)[3]
    sign = torch.where(ey != 0, torch.sign(ey), 0.0)
    mass = o2h_mass(x, y, o2h_i, a * sign / torch.clamp_min(ey.abs(), CS.DIST_EPS)) + eg.abs()
    require(scatter_mass_close(cg[ok], eg[ok], mass[ok]), f"signed cluster: gx differs on certified frames by "
            f"{(cg - eg)[ok].abs().max().item()}")
    print(f"signed cluster entry point F={f6} P2={TRAIN_P}: launches {counts}; y2x equal to the exact pair, "
          f"x2y and gx on the {int(ok.sum())} of {f6} frames whose certificate is clear (o2h overflow "
          f"{int(ovf_o.sum())})", flush=True)
    return counts


def r_cluster_entry_point() -> None:
    """launch/train_r.main on the synthetic smoke config with
    --train.h2o_backend cluster --train.val_freq 1, on the card: it trains
    through #10/#11 and its val passes log the certificate (128 points:
    one cell, certified)."""
    import logging

    import torch

    from oakink2_tamf_tpu_torch.launch import train_r

    root = os.path.dirname(os.path.abspath(__file__))
    kernels = _cluster_kernel_objects()
    _zero_counts(kernels)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    lg = logging.getLogger("oakink2_tamf_tpu_torch.launch.train_r")
    handler, level = Keep(level=logging.INFO), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        state = train_r.main(["--cfg", os.path.join(root, "config/synthetic_smoke.yml"), "--exp_id",
                              "chip_smoke_r_cluster", "--train.h2o_backend", "cluster", "--train.val_freq", "1"])
        torch.cuda.synchronize()
    finally:
        lg.removeHandler(handler)
        lg.setLevel(level)
    counts = {n: k.launches for n, k in kernels.items()}
    msgs = [r.getMessage() for r in records]
    ok = [m for m in msgs if "cluster-exactness certificate ok" in m]
    require(state.step == 4 and all(torch.isfinite(p).all() for p in state.model.parameters()),
            "train_r.main (cluster): wrong step count or non-finite weights")
    require(counts["h2o_topk"] > 0 and counts["h2o_topk_bwd"] == 4, f"train_r.main (cluster): launches {counts}")
    require(bool(ok) and not any(r.levelno >= logging.WARNING for r in records),
            f"train_r.main (cluster): no certificate line, or a warning: {msgs}")
    print(f"train_r.main (synthetic_smoke.yml, cuda, h2o_backend cluster, val_freq 1): {state.step} steps in "
          f"{time.perf_counter() - t0:.2f} s; launches {counts}; {len(ok)} certificate lines, e.g. "
          f"'{ok[0]}'", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from oakink2_tamf_tpu_torch._device import set_fp32_precision
    from oakink2_tamf_tpu_torch.ops import _build
    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_h2o_bwd as HB
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    set_fp32_precision()
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}", flush=True)

    kernels = [NN.KERNEL, CU.KERNEL, CS.KERNEL, CS.BWD_KERNEL, CL.KERNEL,
               NN.DVEC_KERNEL, CU.DVEC_KERNEL, HB.KERNEL, *CC.KERNELS]
    t0 = time.perf_counter()
    _build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for k in kernels:
        print("\n".join(ln for ln in k.ptxas_log.splitlines() if "Used" in ln or "spill" in ln))

    def phase(label):
        print(f"--- {label} (at {time.perf_counter() - t_start:.1f} s)", flush=True)

    phase("serving kernels")
    kstats = check_kernels()
    phase("training kernels")
    kstats.update(check_training_kernels())
    phase("R kernels")
    kstats.update(check_r_kernels())
    phase("cluster kernels")
    kstats.update(check_cluster_kernels())
    phase("small pipeline parity")
    small_parity()
    phase("small train-step parity")
    small_train_parity()
    phase("small R train-step parity")
    small_r_train_parity()
    phase("small R train-step parity, cluster route")
    small_r_cluster_parity()
    phase("training main path (fused)")
    state, db, train_counts, _ = train_main_path()
    phase("composed route")
    composed_counts = composed_route(state, db)
    del state, db
    torch.cuda.empty_cache()
    phase("entry point")
    entry_point()
    phase("gt_geom cache")
    gt_cache_path()
    phase("R training main path (cull route)")
    r_state, r_counts, _ = r_train_main_path()
    phase("R all-pairs route")
    r_ap_counts = r_all_pairs_route(r_state)
    del r_state
    torch.cuda.empty_cache()
    phase("R entry point")
    r_entry_point()
    phase("R training main path (cluster route)")
    rc_counts, _ = r_cluster_main_path()
    phase("signed entry point, cluster route")
    sc_counts = signed_cluster_entry_point()
    phase("R entry point, cluster route")
    r_cluster_entry_point()
    phase("grad_y path")
    gy_counts = grad_y_path()
    phase("serving main path, cull route")
    cull_counts, _ = main_path(8192, "", "h2o_cull", "main path (cull route, 8192 points)")
    phase("serving main path, all-pairs route")
    nn_counts, _ = main_path(2048, "50", "h2o_nn", "main path (all-pairs route, 2048 points)")
    # each kernel's count from the path that runs it: serving for #1/#2, the
    # fused G training path for #6/#8, the composed route for #7, the R
    # training paths for #3 (cull) and #4 (all-pairs), the grad_y path for
    # #5, the R cluster route for #10/#11, the signed cluster entry point
    # for #12/#13
    launches = {"h2o_nn": nn_counts["h2o_nn"], "h2o_cull": cull_counts["h2o_cull"],
                "nn_signed": train_counts["nn_signed"], "dist_loss": train_counts["dist_loss"],
                "nn_signed_bwd": composed_counts["nn_signed_bwd"],
                "h2o_cull_dvec": r_counts["h2o_cull_dvec"], "h2o_nn_dvec": r_ap_counts["h2o_nn_dvec"],
                "h2o_nn_bwd": gy_counts["h2o_nn_bwd"],
                "h2o_topk": rc_counts["h2o_topk"], "h2o_topk_bwd": rc_counts["h2o_topk_bwd"],
                "o2h_topk": sc_counts["o2h_topk"], "o2h_topk_bwd": sc_counts["o2h_topk_bwd"]}

    line = {"kernels": []}
    for name, st in kstats.items():
        k = st["kernel"]
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"oakink2_tamf_tpu_torch/ops/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": launches[name],
            "max_abs_err": st["max_abs_err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            "library_ms": st["library_ms"],
        })
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
