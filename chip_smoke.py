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
   then time kernel and plain version at the G training shape (40960
   frames = batch 64 x 4 object slots x 160 frames), and torch.cdist with
   min/argmin both ways as the signed forward's library yardstick;
4. a small G train step on the GPU and on the CPU with the same weights,
   batch, t and noise, dropout 0, on both dist routes: loss and gradients
   must agree;
5. the training main path: G at arch_mdm_l, batch 64 x 160 frames x 4
   objects x 8192 points, 1000-step cosine schedule, dist_impl="auto"
   (fused), synthetic segments, one warm-up step then 3 timed steps; the
   signed forward (GT side) and the fused loss kernel must launch once per
   step; then the step's split on the same batch;
6. the composed route: the same model and batch, 2 steps; the signed
   forward and its backward kernel must launch;
7. the entry point: launch/train_g.main on config/synthetic_smoke.yml on
   the card (two short epochs);
8. the serving main path, cull route: TamfPipeline at arch_mdm_l G,
   default R, synthetic MANO, random-init CLIP with the hash tokenizer,
   1000 DDPM steps, batch 16 x 160 frames x 4 objects x 8192 points; one
   generate of 16 segments; the culled kernel must have launched;
9. the all-pairs route: the same at 2048 points with 50 respaced steps; the
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
        r_ms = cuda_time_ms(lambda: refine_forward(pipe.refine_net, pipe.mano_stack, b2,
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
    out["nn_signed"] = dict(
        kernel=CS.KERNEL, max_abs_err=err6, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: CS.launch(*ops, L), reps=3),
        plain_ms=cuda_time_ms(lambda: CS.plain(*ops, L), reps=1, warmup=0),
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
        plain_ms=cuda_time_ms(lambda: CL.plain(*lops, L), reps=1, warmup=0),
        library_ms=None, bound_ms=b8, bound_by=by8,
    )
    for name, o in ((k, out[k]) for k in ("nn_signed", "nn_signed_bwd", "dist_loss")):
        lib = "none" if o["library_ms"] is None else f"{o['library_ms']:.3f}"
        print(f"{name} F={F} P1={P1} P2={P2}: ms={o['ms']:.4f} plain_ms={o['plain_ms']:.3f} "
              f"library_ms={lib} bound_ms={o['bound_ms']:.4f} ({o['bound_by']})", flush=True)
    print(f"dist_loss live frames {live} of {F}", flush=True)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from oakink2_tamf_tpu_torch._device import set_fp32_precision
    from oakink2_tamf_tpu_torch.ops import _build
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    set_fp32_precision()
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}", flush=True)

    kernels = [NN.KERNEL, CU.KERNEL, CS.KERNEL, CS.BWD_KERNEL, CL.KERNEL]
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
    phase("small pipeline parity")
    small_parity()
    phase("small train-step parity")
    small_train_parity()
    phase("training main path (fused)")
    state, db, train_counts, _ = train_main_path()
    phase("composed route")
    composed_counts = composed_route(state, db)
    del state, db
    torch.cuda.empty_cache()
    phase("entry point")
    entry_point()
    phase("serving main path, cull route")
    cull_counts, _ = main_path(8192, "", "h2o_cull", "main path (cull route, 8192 points)")
    phase("serving main path, all-pairs route")
    nn_counts, _ = main_path(2048, "50", "h2o_nn", "main path (all-pairs route, 2048 points)")
    # each kernel's count from the path that runs it: serving for #1/#2, the
    # fused training path for #6/#8, the composed route for #7
    launches = {"h2o_nn": nn_counts["h2o_nn"], "h2o_cull": cull_counts["h2o_cull"],
                "nn_signed": train_counts["nn_signed"], "dist_loss": train_counts["dist_loss"],
                "nn_signed_bwd": composed_counts["nn_signed_bwd"]}

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
