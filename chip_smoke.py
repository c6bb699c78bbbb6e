#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (oakink2_tamf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
1. build the CUDA kernels from ops/csrc (one nvcc per source, in parallel),
   print ptxas' registers and spills, and the SASS hot loop of #1-#4, #6,
   #8, #9, #10 and #12 (instructions per pair, cuobjdump) and the scatter loop
   of #7 and #13 (instructions per point);
2. serving kernels: check each against its plain PyTorch version on the
   card at the serving path's shapes (10240 frames = 64 clouds x 160
   frames, 778 hand rows, 2048 / 8192 object points) with ragged y_valid,
   one all-invalid cloud and x_valid=False frames; check that the two
   kernels' values are bit-identical on valid frames; time kernel, plain
   version and torch.cdist(...).amin(-1) as the library yardstick (#1's
   bound counts each row against the valid points of its cloud); #2 and
   #3 at the mask tiles 2048, 1024, 512, 256 and 128 (the tile sweep: the
   share of pairs the mask keeps, cull_mask's ms, #3's and #2's ms; their
   outputs bit-equal across tiles);
3. training kernels (signed pair forward and backward, fused loss): check
   each against its plain version at 8192 points and 778 rows on 32 frames,
   with a ragged cloud, an all-zero padded slot and x_valid=False frames;
   then time each kernel at the G training shape (40960 frames = batch 64
   x 4 object slots x 160 frames), its plain version on 1/8 of those
   frames (x 8; #6's and #8's outputs are held against it there), and
   torch.cdist with min/argmin both ways as the signed forward's library
   yardstick, a gather and index_add_ as #7's, and the distinct rows per 32
   consecutive live points that #7's scatter meets; then #6 and #8 on tie
   scenes (exact duplicate points and rows
   at the seams of their bidirectional search) at ragged P1 and P2, y_group
   1 and 8, with an all-invalid cloud and x_valid=False frames, against
   their plain versions; then the region-culled loss kernel (#9) on
   the same shape with the template permutation and an all-invalid slot:
   against its plain version on 1/8 of the frames, bit-equal to #8 on live
   frames, the mask's run and candidate shares, timed with the mask stage
   and #8 on the same operands; #9 on the tie scenes at tiles 2048, 512
   and 640 under masks that drop blocks, and on a separated scene whose
   mask keeps well under all blocks (its run share printed), against its
   plain version and #8; then #7 and #13 on contention scenes (every
   point on one row, two rows on alternating lanes, all rows distinct,
   pairs that cancel, zero cotangents and indices out of range, a padded
   slot; 100, 2000 and 8192 points; #7 at grad_y False and True, y_group 1
   and 2): gx against the plain versions within 1e-6 of the terms'
   magnitudes per frame and every element within the float32 sum bound of
   the float64 sum, #7's gy too, #13's gy equal;
4. R kernels (#3 culled dvec, #4 all-pairs dvec, #5 h2o backward): check
   each against its plain version on 32 frames x 778 rows x 8192 points
   (ragged cloud, all-invalid cloud, x_valid=False frames; #5 in both
   grad_y modes); time them at the R training shape (40960 frames against
   8192 points for #3 and 2048 for #4; #5 at 10240 x 778 x 2048) and hold
   them against their plain versions there too (#3/#4 on the 1/8 of the
   frames the plain versions are timed on); the tile sweep there (#2 at
   the R shape too); then #2 and #3 on a scene whose minima tie across
   cells (ragged, all-invalid and far clouds, x_valid=False frames, 778 x
   4000 points) at tiles 2048, 640 and 128, under its own mask and under
   masks that drop ~40% of the blocks: bit-equal to their plain versions,
   #3 the same at every tile and equal to #4 on live frames; then #1 and #4
   on the all-pairs tie scene (copies across cells, an all-invalid middle
   cell, ragged and all-invalid clouds, x_valid=False frames; 778 x 2000
   points, y_group 3 and 1): values, indices and dvec bit-equal to their
   plain versions, #4 equal to #3 on live frames;
5. cluster kernels (#10 h2o over candidate cells, #11 its backward, #12
   o2h over candidate tiles, #13 its backward) on the R main path's own
   operands (sample hands in the canonical frames of a full-width batch,
   template permutation): each against its plain version; #10 against #1
   (equal on rows of certified tiles, never below; the overflowed-tile
   share is printed); #12 at k_tiles 0 against #6's o2h half; each timed
   at 40960 frames x 778 x 8192 with the selection stage (#13 with the
   distinct rows per 32 live points its scatter meets); #10 on a tie
   scene with reversed candidate lists, an empty cell in each list, an
   all-invalid cloud and ids out of range, against its plain version;
   #12 on the tie scenes of tests/test_torch_o2h_cells.py (rows copied
   within a segment, across segments and tiles, an all-invalid cell and
   frame, every tile listed and 4 reversed ones, at P1 x P2 778 x 1000
   and 300 x 700, then ids out of range)
   against that test's numpy reference and its plain version; then #8's,
   #9's, #10's, #2's, #3's, #1's, #4's and #12's registers, SASS
   instructions per pair, times, bounds and issue floors side by side
   (#2/#3 at the shipped tile and at 2048, with the mask's kept share and
   ms; #1/#4/#12 with their valid and searched pairs and the share of
   cells with a valid point); #7's and #13's registers, SASS instructions per
   point, times, bounds, library times and rows per warp;
6. small GPU-vs-CPU parity: the serving pipeline, a G train step on the
   three dist routes and an R train step on all three h2o routes (same
   weights, batch and noise, dropout 0): loss and gradients must agree;
7. the G training main path: arch_mdm_l, batch 64 x 160 frames x 4 objects
   x 8192 points, 1000-step cosine schedule, dist_impl="auto" (fused),
   synthetic segments, one warm-up step then 3 timed steps; the signed
   forward (GT side) and the fused loss kernel must launch once per step;
   then the step's split on the same batch; then the same on
   dist_impl="fused_cull" (#9 once per step, #8 and #7 never), its split
   with the mask stage on its own line;
8. the composed route: the same model and batch, 2 steps; the signed
   forward and its backward kernel must launch; then a third step whose
   #7 operands are kept, #7 timed on them with the distinct rows per 32
   live points it meets there;
9. the entry point: launch/train_g.main on config/synthetic_smoke.yml on
   the card (two short epochs), on the fused and the fused_cull routes;
10. the gt_geom cache: train_g.main with train.data.cache_gt_geom (the
   signed forward runs in the precompute, not in the steps), then a fresh
   cache's cold misses computed in the loader's threads against the
   batched precompute;
11. the R training main path, cull route: arch_refine, batch 64 x 160
   frames x 4 objects x 8192 points with target_h2o from TargetH2OCache,
   one warm-up step then 3 timed steps and the step's split; #2 and #3
   must launch once per step; the tile sweep on the operands the step
   hands #3; then the same on the all-pairs route at 2048 points (#1 and
   #4 once per step, no culled kernel), its split, and #1 and #4 timed on
   the operands the step hands them, with the share of cells that hold a
   valid point;
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

import contextlib
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
# Issue rate: 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz (H100 SXM boost).
PEAK_LANE_INSTR_PER_S = 132 * 128 * 1.98e9
# The least a bidirectional search issues per pair: the pinned distance's 6
# (3 FADD, 1 FMUL, 2 FFMA) and one minimum update per direction.
INSTR_PER_PAIR = 8


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


def issue_floor_ms(n_pairs: float, instr_per_pair: int = INSTR_PER_PAIR) -> float:
    """The least time the card's warp schedulers need to issue a pair
    search's instructions: INSTR_PER_PAIR per pair (a search of one
    direction, 7: the distance's 6 and a minimum) at the published SM count
    and boost clock."""
    return n_pairs * instr_per_pair / PEAK_LANE_INSTR_PER_S * 1e3


def ptxas_registers(kernel) -> int:
    """The registers ptxas gave the kernel of a library (its build log)."""
    import re

    m = re.search(r"Used (\d+) registers", kernel.ptxas_log)
    return int(m.group(1)) if m else -1


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
    # --- all-pairs kernel at 2048 points --------------------------------
    # the plain version repeats the kernel's rounding (f32 subtract, f32
    # mul, two once-rounded fmas): bit-equal
    x, y, yv, xv, L = kernel_inputs(2048)
    ops = NN.prepare(x, y, yv, L)
    d, idx = NN.launch(*ops, L)
    torch.cuda.synchronize()
    dp, ip = NN.plain(*ops, L)
    err = (d - dp).abs().max().item()
    require(torch.equal(d, dp), f"h2o_nn vs plain: max abs err {err}")
    require(torch.equal(idx, ip), "h2o_nn argmin differs from the plain version")
    del dp, ip
    F, P1 = d.shape
    G, P2 = y.shape[:2]
    xc = NN.centred_x(ops[0], ops[2], L).reshape(G, L * P1, 3)
    yc = ops[1][..., :3].contiguous()
    # the prepared operands and the cell flags read once, d and idx written
    # once; the work: each row against each valid point of its cloud
    w = all_pairs_work(yv, L, P1)
    n_bytes = sum(t.numel() * 4 for t in ops) + G * (-(-P2 // 128)) + F * P1 * 8
    b, by = bound_ms(n_bytes, w["pairs"])
    out["h2o_nn"] = dict(
        kernel=NN.KERNEL, max_abs_err=err, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: NN.launch(*ops, L), reps=10),
        plain_ms=cuda_time_ms(lambda: NN.plain(*ops, L), reps=1),
        library_ms=cuda_time_ms(lambda: library_min(xc, yc), reps=3),
        bound_ms=b, bound_by=by, **w,
    )
    o = out["h2o_nn"]
    print(f"h2o_nn   F={F} P1={P1} P2={P2}: max_abs_err={err} ms={o['ms']:.4f} "
          f"plain_ms={o['plain_ms']:.3f} library_ms={o['library_ms']:.3f} "
          f"bound_ms={b:.4f} ({by}; {w['pairs']:.6g} valid pairs, {w['searched']:.6g} searched, cells with a "
          f"valid point {w['cell_share']:.4f})", flush=True)
    del x, y, ops, d, idx, xc, yc
    torch.cuda.empty_cache()

    # --- culled kernel at 8192 points, and bit-identity with all-pairs ----
    x, y, yv, xv, L = kernel_inputs(8192, seed=1)
    tile = CU.DEFAULT_TILE
    mask = CU.cull_mask(x, y, yv, tile, L, xv)
    ops = NN.prepare(x, y, yv, L)
    dc = CU.launch(*ops, mask, L, tile)
    torch.cuda.synchronize()
    dcp, plain_ms = cuda_timed(lambda: CU.plain(*ops, mask, L, tile))
    err = (dc - dcp).abs().max().item()
    require(torch.equal(dc, dcp), f"h2o_cull vs plain at tile {tile}: max abs err {err}")
    del dcp
    da, _ = NN.launch(*ops, L)
    torch.cuda.synchronize()
    valid_rows = (xv & yv.any(dim=1).repeat_interleave(L))[:, None].expand_as(dc)
    require(torch.equal(dc[valid_rows], da[valid_rows]), "h2o_cull and h2o_nn values differ on valid frames")
    require(bool((dc[~valid_rows] == CU.BIG).all()), "culled rows are not BIG")
    print(f"h2o_cull (tile {tile}) and h2o_nn: bit-identical on valid frames", flush=True)
    F, P1 = dc.shape
    G, P2 = y.shape[:2]
    sweep = tile_sweep("h2o_cull's serving shape", x, y, yv, xv, L)
    xc = NN.centred_x(ops[0], ops[2], L).reshape(G, L * P1, 3)
    yc = ops[1][..., :3].contiguous()
    out["h2o_cull"] = dict(
        kernel=CU.KERNEL, max_abs_err=err, shape=[F, P1, P2], plain_ms=plain_ms,
        library_ms=cuda_time_ms(lambda: library_min(xc, yc), reps=2),
        all_pairs_ms=cuda_time_ms(lambda: NN.launch(*ops, L), reps=5),
        **cull_stats(sweep, "cull_ms"),
    )
    o = out["h2o_cull"]
    print(f"h2o_cull F={F} P1={P1} P2={P2}: max_abs_err={err} ms={o['ms']:.4f} (tile {tile}; at tile 2048 "
          f"{o['ms_2048']:.4f}) plain_ms={o['plain_ms']:.3f} library_ms={o['library_ms']:.3f} "
          f"bound_ms={o['bound_ms']:.4f} ({o['bound_by']}) kept share={o['kept_share']:.4f} "
          f"mask_ms={o['mask_ms']:.4f} h2o_nn at 8192 points ms={o['all_pairs_ms']:.4f}", flush=True)
    del x, y, ops, dc, da, xc, yc, mask
    torch.cuda.empty_cache()
    return out


def cull_pairs(mask, P1: int, P2: int, tile: int) -> float:
    """The (real row, point) pairs of the blocks a cull mask [F, R, T] keeps:
    the work of #2 and #3."""
    import torch

    R, T = mask.shape[1:]
    rows = torch.tensor([min(128, P1 - 128 * r) for r in range(R)], device=mask.device, dtype=torch.float64)
    cols = torch.tensor([min(tile, P2 - tile * t) for t in range(T)], device=mask.device, dtype=torch.float64)
    return float(((mask != 0).double() * rows[None, :, None] * cols[None, None, :]).sum())


SWEEP_TILES = (2048, 1024, 512, 256, 128)


def tile_sweep(label: str, x, y, yv, xv, L: int, reps: int = 3) -> dict:
    """#2 and #3 on one set of operands at the mask tiles SWEEP_TILES: per
    tile the kept share (the pairs the mask keeps over all pairs of the
    frames that search: x_valid with a valid point), the pairs, cull_mask's
    ms, #3's and #2's ms; #3's and #2's outputs at every tile bit-equal to
    those at tile 2048. One line; returns {tile: stats}."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    F, P1, _ = x.shape
    P2 = y.shape[1]
    live = xv & yv.any(dim=1).repeat_interleave(L)
    ops = NN.prepare(x, y, yv, L)
    base = sum(t.numel() * 4 for t in ops)
    res, ref = {}, None
    for tile in SWEEP_TILES:
        mask = CU.cull_mask(x, y, yv, tile, L, xv)
        got = (*CU.launch_dvec(*ops, mask, L, tile), CU.launch(*ops, mask, L, tile))
        ref = ref or got
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"{label}: h2o_cull_dvec / h2o_cull at tile {tile} differ from tile {SWEEP_TILES[0]}")
        pairs = cull_pairs(mask, P1, P2, tile)
        res[tile] = dict(
            pairs=pairs, kept_share=pairs / max(1.0, float(live.sum()) * P1 * P2),
            # each operand read once (x, y4 with its padding word, ctr, mask),
            # each output written once (#2: d; #3: d and dvec)
            bytes={"cull_ms": base + mask.numel() * 4 + F * P1 * 4,
                   "dvec_ms": base + mask.numel() * 4 + F * P1 * 16},
            mask_ms=cuda_time_ms(lambda: CU.cull_mask(x, y, yv, tile, L, xv), reps=reps),
            dvec_ms=cuda_time_ms(lambda: CU.launch_dvec(*ops, mask, L, tile), reps=reps),
            cull_ms=cuda_time_ms(lambda: CU.launch(*ops, mask, L, tile), reps=reps),
        )
        del mask, got
    del ref
    torch.cuda.empty_cache()
    best = min(res, key=lambda t: res[t]["mask_ms"] + res[t]["dvec_ms"])
    print(f"tile sweep ({label}, F={F} P1={P1} P2={P2}, {int(live.sum())} frames search; outputs bit-equal across "
          f"tiles): " + "; ".join(f"{t}: kept {r['kept_share']:.4f} mask {r['mask_ms']:.3f} ms #3 {r['dvec_ms']:.3f} "
                                  f"ms #2 {r['cull_ms']:.3f} ms" for t, r in res.items())
          + f"; least mask + #3 at tile {best}", flush=True)
    return res


def cull_stats(sweep: dict, which: str) -> dict:
    """A kernel's numbers at the shipped tile and at 2048 from a tile sweep
    (which: "cull_ms" for #2, "dvec_ms" for #3): ms, kept pairs and share,
    mask ms, bound (8 flops per kept pair, or the operands' bytes), issue
    floor (7 instructions per kept pair)."""
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU

    out = {}
    for tile, sfx in ((CU.DEFAULT_TILE, ""), (2048, "_2048")):
        r = sweep[tile]
        out[f"ms{sfx}"] = r[which]
        out[f"pairs{sfx}"] = r["pairs"]
        out[f"kept_share{sfx}"] = r["kept_share"]
        out[f"mask_ms{sfx}"] = r["mask_ms"]
        out[f"issue_floor_ms{sfx}"] = issue_floor_ms(r["pairs"], 7)
    b, by = bound_ms(sweep[CU.DEFAULT_TILE]["bytes"][which], sweep[CU.DEFAULT_TILE]["pairs"])
    out.update(bound_ms=b, bound_by=by)
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


def gy_sum_bound_share(got, exact) -> float:
    """max over elements of |got - gy| / ((n + 2) u mass), u = 2^-24, with
    (gy, mass, n) one half of backward_exact; at most
    1 for any float32 sum of the n terms, in any order, each a product of a
    difference (two roundings).
    Atomic additions land in a run-dependent order, so the kernel's gy is
    held to the bound that every order obeys: a per-frame rtol fails on a
    frame whose rows all take one point and cancel (an all-invalid cloud).
    A point with no row must be exactly 0 (share inf otherwise); a missing
    or doubled term exceeds the bound unless it is below (n + 2) u of its
    point's mass."""
    import torch

    gy, mass, n = exact
    err = (got.double() - gy).abs()
    bound = (n + 2) * 2.0 ** -24 * mass
    share = torch.where(bound > 0, err / bound.clamp_min(1e-300), torch.where(err > 0, torch.inf, 0.0))
    return share.max().item()


def cancellation(exact) -> float:
    """max over frames of ||mass_f|| / ||gy_f||: how far a frame's gy
    cancels its terms."""
    gy, mass, _ = exact
    return (mass.flatten(1).norm(dim=1) / gy.flatten(1).norm(dim=1).clamp_min(1e-300)).max().item()


def o2h_mass(x, y, o2h_i, yc):
    """[F, P1, 3]: the scatter of |yc_j (y_j - x_{o2h_i[j]})| onto the rows
    (one cloud per frame; an index outside [0, P1) adds nothing): the
    magnitude that #13's and #7's o2h-side scatters sum."""
    import torch

    F, P1, _ = x.shape
    ok = (o2h_i >= 0) & (o2h_i < P1)
    flat = (torch.arange(F, device=x.device)[:, None] * P1 + torch.where(ok, o2h_i, 0).long()).reshape(-1)
    u = torch.where(ok[..., None], (yc[..., None] * (y - x.reshape(-1, 3)[flat].reshape(y.shape))).abs(), 0.0)
    return torch.zeros((F * P1, 3), device=x.device).index_add_(0, flat, u.reshape(-1, 3)).reshape(x.shape)


def backward_exact(x, y, o2h_i, yc, h2o_i=None, xr=None, y_group: int = 1):
    """The signed pair's backward summed in float64: gx [F, P1, 3] and gy
    [F, P2, 3], each as (sum, the terms' absolute sum, their count),
    gy_sum_bound_share's operand; the o2h side's terms (#13, #7) unless
    o2h_i is None, the h2o side's (#5, #11, #7) with h2o_i. A term needs a
    nonzero cotangent and an index in range; the kernels' formula on
    float64 copies of their float32 operands."""
    import torch

    F, P1, _ = x.shape
    P2 = y.shape[1]
    dev = x.device
    xd, yd = x.double(), y.double().repeat_interleave(y_group, 0)
    gx = [torch.zeros((F * P1, 3), dtype=torch.float64, device=dev) for _ in range(3)]
    gy = [torch.zeros((F * P2, 3), dtype=torch.float64, device=dev) for _ in range(3)]

    def add(acc, at, t):
        acc[0].index_add_(0, at, t)
        acc[1].index_add_(0, at, t.abs())
        acc[2].index_add_(0, at, torch.ones_like(t))

    if o2h_i is not None:
        f, j = torch.nonzero((yc != 0) & (o2h_i >= 0) & (o2h_i < P1), as_tuple=True)
        i = o2h_i[f, j].long()
        t = yc[f, j, None].double() * (yd[f, j] - xd[f, i])
        add(gx, f * P1 + i, -t)
        add(gy, f * P2 + j, t)
    if h2o_i is not None:
        f, i = torch.nonzero((xr != 0) & (h2o_i >= 0) & (h2o_i < P2), as_tuple=True)
        j = h2o_i[f, i].long()
        v = xr[f, i, None].double() * (xd[f, i] - yd[f, j])
        add(gx, f * P1 + i, v)
        add(gy, f * P2 + j, -v)
    return (tuple(a.reshape(F, P1, 3) for a in gx), tuple(a.reshape(F, P2, 3) for a in gy))


def contention_scene(P2: int, y_group: int, seed: int, P1: int = 778):
    """Operands (x, y, o2h_i, yc, h2o_i, xr) on the card of an o2h scatter
    (#7, #13) whose frames stress its parts: 0 every point on one row (and
    every row of the h2o side on one point), 1 two rows on alternating
    lanes, 2 all rows distinct within any 778 consecutive points, 3 pairs of
    coincident points with cotangents c and -c on runs of 64 points per row
    (each row's terms cancel exactly), 4 half the cotangents zero and
    indices out of range with nonzero cotangents (-1, P1, P1 + 100, 2^30,
    -2^31; on the h2o side -1 and 2^30), 5 a padded, all-invalid slot (every
    cotangent zero); y has 6 / y_group clouds."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    F = 6
    y = rng.normal(scale=0.05, size=(F // y_group, P2, 3))
    x = rng.normal(scale=0.05, size=(F, P1, 3))
    j = np.arange(P2)
    o2h = np.stack([np.full(P2, 5), 100 + j % 2, (37 * j) % P1, (j // 64) % P1,
                    np.sort(rng.integers(0, P1, P2)), (j // 16) % P1])
    yc = rng.normal(size=(F, P2))
    half = P2 // 2
    y[3 // y_group, 1 : 2 * half : 2] = y[3 // y_group, 0 : 2 * half : 2]
    yc[3, 1 : 2 * half : 2] = -yc[3, 0 : 2 * half : 2]
    yc[4, rng.random(P2) < 0.5] = 0.0
    bad = rng.choice(P2, 5, replace=False)
    o2h[4, bad] = (-1, P1, P1 + 100, 2**30, -(2**31))
    yc[4, bad] = 1.0 + rng.random(5)
    yc[5] = 0.0
    h2o = rng.integers(0, P2, (F, P1))
    h2o[0] = 7
    xr = rng.normal(size=(F, P1))
    xr[:, ::7] = 0.0
    h2o[4, [3, 10]] = (-1, 2**30)
    xr[4, [3, 10]] = 1.5
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()  # noqa: E731
    return f32(x), f32(y), i32(o2h), f32(yc), i32(h2o), f32(xr)


def check_scatter_contention() -> dict[str, float]:
    """#7 and #13 on contention_scene at 100, 2000 and 8192 points (ragged
    and empty warp chunks, and the main paths' 8192), #7 at grad_y False
    and True, y_group 1 and 2, #13 at grad_y False and True: against their
    plain versions on the card, gx per frame within 1e-6 of its terms'
    magnitudes (scatter_mass_close: for #7 o2h_mass plus the h2o side's)
    and, with #7's gy, every element of both within the float32 sum bound
    of the float64 sum (gy_sum_bound_share <= 1); #13's gy equal. Returns
    the worst share per kernel."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    worst = {"nn_signed_bwd": 0.0, "o2h_topk_bwd": 0.0}
    for P2 in (100, 2000, 8192):
        for grad_y, y_group in ((False, 1), (True, 1), (False, 2)):
            x, y, o2h, yc, h2o, xr = contention_scene(P2, y_group, seed=P2)
            gx, gy = CS.backward_launch(x, y, h2o, o2h, xr, yc, grad_y, y_group)
            px, py = CS.backward_plain(x, y, h2o, o2h, xr, yc, grad_y, y_group)
            ex, ey = backward_exact(x, y, o2h, yc, h2o, xr, y_group)
            where = f"nn_signed_bwd on the contention scene (P2 {P2}, grad_y {grad_y}, y_group {y_group})"
            require(scatter_mass_close(gx, px, ex[1]), f"{where}: gx differs from plain beyond 1e-6 of the magnitudes")
            pairs = [(gx, px, ex)] + ([(gy, py, ey)] if grad_y else [])
            share = max(gy_sum_bound_share(a, e) for g, p, e in pairs for a in (g, p))
            require(share <= 1.0, f"{where}: {share} of the float32 sum bound")
            worst["nn_signed_bwd"] = max(worst["nn_signed_bwd"], share)
        x, y, o2h, yc, _, _ = contention_scene(P2, 1, seed=P2 + 1)
        ex, _ = backward_exact(x, y, o2h, yc)
        mass = o2h_mass(x, y, o2h, yc)
        for grad_y in (False, True):
            gx, gy = CC.launch_o2h_backward(x, y, o2h, yc, grad_y)
            px, py = CC.plain_o2h_backward(x, y, o2h, yc, grad_y)
            where = f"o2h_topk_bwd on the contention scene (P2 {P2}, grad_y {grad_y})"
            require(scatter_mass_close(gx, px, mass), f"{where}: gx differs from plain beyond 1e-6 of the magnitudes")
            share = max(gy_sum_bound_share(gx, ex), gy_sum_bound_share(px, ex))
            require(share <= 1.0, f"{where}: {share} of the float32 sum bound")
            require(not grad_y or torch.equal(gy, py), f"{where}: gy differs from plain")
            worst["o2h_topk_bwd"] = max(worst["o2h_topk_bwd"], share)
    torch.cuda.synchronize()
    print(f"o2h scatter contention scenes (one row, alternating rows, distinct rows, cancelling pairs, zero "
          f"cotangents and indices out of range, a padded slot; 100 / 2000 / 8192 points): nn_signed_bwd "
          f"(grad_y False/True, y_group 1/2) within {worst['nn_signed_bwd']:.4g} and o2h_topk_bwd within "
          f"{worst['o2h_topk_bwd']:.4g} of the float32 sum bound, gx within 1e-6 of the magnitudes per frame, "
          f"#13's gy equal", flush=True)
    return worst


def rows_per_warp(o2h_i, yc, chunk: int = 2048) -> float:
    """What an o2h scatter meets (#7, #13): the mean number of distinct rows
    i* per 32 consecutive live points of a frame (live: a nonzero cotangent
    and an index in [0, P1)); P1 = 778."""
    import torch

    F, P2 = o2h_i.shape
    n_groups = -(-P2 // 32)
    rows = groups = 0
    for a in range(0, F, chunk):
        oi, c = o2h_i[a : a + chunk].long(), yc[a : a + chunk]
        live = (c != 0) & (oi >= 0) & (oi < 778)
        g = (torch.arange(oi.shape[0], device=oi.device)[:, None] * n_groups + (live.cumsum(1) - 1) // 32)[live]
        rows += torch.unique(g * 778 + oi[live]).numel()
        groups += torch.unique(g).numel()
    return rows / max(groups, 1)


def scatter_sass(kernel) -> dict:
    """The hot loop of an o2h scatter's SASS (#7, #13): sass_inner_loop on
    the grad_y=False kernel's loop that holds the warp votes; its FMULs are
    the terms' products, 3 per point, so per point = instructions x 3 /
    FMULs."""
    st = sass_inner_loop(kernel, function="ILb0E", with_ops=("VOTE", "VOTEU", "MATCH"))
    if not st["pairs"]:  # a build without the warp votes (an earlier design): its loop of products
        st = sass_inner_loop(kernel, function="ILb0E")
    pts = max(st["pairs"], 1) / 3
    return dict(st, per_point=st["instructions"] / pts, fast_per_point=st["fast_path"] / pts)


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
    # the plain version's outputs on those frames are held against the
    # kernel's at this shape too: equal values and first-min indices
    want, plain_ms = cuda_timed(lambda: CS.plain(ops[0][:f8], ops[1][:f8], ops[2][:g8], ops[3][:g8], L))
    for nm, a, w in zip(names, fwd, want):
        require(torch.equal(a[:f8], w), f"nn_signed {nm} differs from the plain version at the G shape")
    del want
    print(f"nn_signed F={f8} of {F} P1={P1} P2={P2} y_group={L}: equal to plain", flush=True)
    out["nn_signed"] = dict(
        kernel=CS.KERNEL, max_abs_err=err6, shape=[F, P1, P2],
        ms=cuda_time_ms(lambda: CS.launch(*ops, L), reps=3),
        plain_ms=8 * plain_ms,
        library_ms=cuda_time_ms(lambda: library_signed(xc, ops[2][..., :3].contiguous(), L, P1), reps=1),
        bound_ms=b, bound_by=by, issue_floor_ms=issue_floor_ms(pairs),
    )
    del xc
    h2o_i, o2h_i = fwd[1], fwd[3]
    del fwd
    xr = torch.randn(F, P1, device="cuda")
    yc = torch.randn(F, P2, device="cuda")
    b7, by7 = bound_ms(x.numel() * 4 + y.numel() * 4 + F * P1 * 8 + F * P2 * 8 + F * P1 * 12, 0)
    rpw = rows_per_warp(o2h_i, yc)
    out["nn_signed_bwd"] = dict(
        kernel=CS.BWD_KERNEL, max_abs_err=err7, shape=[F, P1, P2], rows_per_warp=rpw,
        ms=cuda_time_ms(lambda: CS.backward_launch(x, y, h2o_i, o2h_i, xr, yc, False, L), reps=10),
        plain_ms=cuda_time_ms(lambda: CS.backward_plain(x, y, h2o_i, o2h_i, xr, yc, False, L), reps=1, warmup=0),
        library_ms=cuda_time_ms(lambda: library_nn_signed_bwd(x, y, h2o_i, o2h_i, xr, yc, L), reps=1),
        bound_ms=b7, bound_by=by7,
    )
    print(f"nn_signed_bwd F={F} P1={P1} P2={P2} y_group={L}: distinct rows per 32 consecutive live points "
          f"{rpw:.4f}", flush=True)
    del h2o_i, o2h_i, xr, yc
    torch.cuda.empty_cache()
    lops = CL.prepare(x, n, y, og, hg, vw, None, xv, L)
    live = int(xv.sum())
    b8, by8 = bound_ms(2 * x.numel() * 4 + y.numel() * 4 + F * P2 * 8 + F * P1 * 8 + F * P1 * 24,
                       live * P1 * P2)
    got = CL.launch(*lops, L)
    want, plain_ms = cuda_timed(lambda: CL.plain(*(t[:f8] for t in lops[:2]), *(t[:g8] for t in lops[2:4]),
                                                 lops[4][:f8], lops[5][:f8], lops[6], lops[7][:f8], L))
    err = 0.0
    for nm, i in (("v", 0), ("dh", 1), ("gx_dh", 3)):
        a, w = got[i][:f8], want[i]
        require(torch.allclose(a, w, rtol=1e-6, atol=1e-7), f"dist_loss {nm} vs plain at the G shape: "
                f"{(a - w).abs().max().item()}")
        err = max(err, (a - w).abs().max().item())
    require(scatter_close(got[2][:f8], want[2]), "dist_loss gx_do vs plain at the G shape: "
            f"{(got[2][:f8] - want[2]).abs().max().item()}")
    err8 = max(err8, err, (got[2][:f8] - want[2]).abs().max().item())
    del got, want
    print(f"dist_loss F={f8} of {F} P1={P1} P2={P2} y_group={L}: plain within tolerance (max abs err {err})",
          flush=True)
    out["dist_loss"] = dict(
        kernel=CL.KERNEL, max_abs_err=err8, shape=[F, P1, P2], live_frames=live, pairs=live * P1 * P2,
        ms=cuda_time_ms(lambda: CL.launch(*lops, L), reps=3),
        plain_ms=8 * plain_ms,
        library_ms=None, bound_ms=b8, bound_by=by8, issue_floor_ms=issue_floor_ms(live * P1 * P2),
    )
    for name, o in ((k, out[k]) for k in ("nn_signed", "nn_signed_bwd", "dist_loss")):
        lib = "none" if o["library_ms"] is None else f"{o['library_ms']:.3f}"
        floor = f" issue_floor_ms={o['issue_floor_ms']:.4f}" if "issue_floor_ms" in o else ""
        print(f"{name} F={F} P1={P1} P2={P2}: ms={o['ms']:.4f} plain_ms={o['plain_ms']:.3f} "
              f"library_ms={lib} bound_ms={o['bound_ms']:.4f} ({o['bound_by']}){floor}", flush=True)
    print(f"dist_loss live frames {live} of {F}; plain_ms of nn_signed and dist_loss: 8 x the time on 1/8 "
          "of the frames", flush=True)
    del x, n, y, xv, og, hg, vw, ops, lops
    torch.cuda.empty_cache()
    return out


def library_nn_signed_bwd(x, y, h2o_i, o2h_i, xr, yc, y_group: int):
    """#7's yardstick (y_group clouds): the gather of each row's point times
    xr (library_gather), then the gather of each point's row times yc,
    index_add_-ed into gx."""
    import torch

    F, P1, _ = x.shape
    G, P2, _ = y.shape
    flat = (torch.arange(F, device=x.device)[:, None] * P1 + o2h_i.long()).reshape(-1)
    x_at = x.reshape(-1, 3)[flat].reshape(G, y_group, P2, 3)
    u = yc[..., None] * (y[:, None] - x_at).reshape(F, P2, 3)
    return library_gather(x, y, h2o_i, xr, y_group).reshape(-1, 3).index_add_(0, flat, -u.reshape(-1, 3))


def sass_inner_loop(kernel, function: str = "", with_ops: tuple = ()) -> dict:
    """The hot loop of a built kernel's SASS (cuobjdump -sass on its
    library): of the innermost loops (backward branches) that hold FMULs,
    the one with the most; an FMUL is one pinned pair distance
    (h2o_pair_d2's fl(d0 d0)), so its count is the pairs per iteration.
    Returns the body's instruction count, the count without the blocks
    that a forward branch skips around a shared atomic (the row merge,
    which runs only when a vote asks for it), the pairs and the opcode
    counts of the body. `function` keeps the functions whose mangled name
    holds it, `with_ops` the loops that hold one of those opcodes."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", kernel._paths()[1]], capture_output=True, text=True, check=True).stdout

    def target(op, labels, addr):
        m = re.search(r"\(?(\.L_x_\d+)\)?", op)
        h = re.search(r"\b0x([0-9a-f]+)\b", op)
        return labels.get(m.group(1)) if m else (addr.get(int(h.group(1), 16)) if h else None)

    def opcode(op):
        return (op.split()[1] if op.startswith("@") else op.split()[0]).split(".")[0]

    insts, labels, best, name = [], {}, None, ""
    for ln in text.splitlines() + ["Function : end"]:
        if "Function :" in ln and function not in name:  # a function not asked for
            insts, labels, name = [], {}, ln.split("Function :", 1)[1].strip()
            continue
        if "Function :" in ln:  # a new function: score the previous one's loops
            addr = {a: k for k, (a, _) in enumerate(insts)}
            loops = []
            for k, (_, op) in enumerate(insts):
                tgt = target(op, labels, addr) if opcode(op) == "BRA" else None
                if tgt is None or tgt > k:
                    continue
                body = insts[tgt : k + 1]
                ops = collections.Counter(opcode(o) for _, o in body)
                if not ops["FMUL"] or (with_ops and not any(ops[o] for o in with_ops)):
                    continue
                skipped = set()
                for b, (_, o) in enumerate(body):  # forward branches around an atomic
                    t = target(o, labels, addr) if opcode(o) == "BRA" else None
                    if t is not None and tgt + b < t <= k + 1 and any(
                            opcode(q) == "ATOMS" for _, q in insts[tgt + b + 1 : t]):
                        skipped.update(range(tgt + b + 1, t))
                loops.append((tgt, k, {"instructions": len(body), "fast_path": len(body) - len(skipped),
                                       "pairs": ops["FMUL"], "opcodes": dict(ops)}))
            for tgt, k, st in loops:  # innermost: no other loop with pairs inside
                if any(tgt <= t2 and k2 <= k and (t2, k2) != (tgt, k) for t2, k2, _ in loops):
                    continue
                if best is None or st["pairs"] > best["pairs"]:
                    best = st
            insts, labels, name = [], {}, ln.split("Function :", 1)[1].strip()
            continue
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            labels[m.group(1)] = len(insts)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            insts.append((int(m.group(1), 16), m.group(2).strip()))
    return best or {"instructions": 0, "fast_path": 0, "pairs": 0, "opcodes": {}}


def tie_scene(G: int, L: int, P1: int, P2: int, seed: int):
    """Operands (x, n, y, yv, xv, og, hg, vw) on the card, made with numpy,
    whose minima tie exactly in both directions at the seams of the
    bidirectional search (256 threads x 4 columns per pass, rows in groups
    of 8):
    - points: every 7th point has an exact copy at +1 (the next lane),
      +32 (the next warp), +256 (the thread's next column), +1024 (the next
      pass), +2048 and +4096, one offset per residue;
    - rows: rows i + 128 copy rows i in alternate 128-row blocks, every
      16th row is copied to the next one (the same group) and every 32nd
      to the one 8 on (the next group); each row keeps its own random
      normal, so the sign shows which of two equal rows won.
    Cloud 1 (of 3) has a ragged y_valid, cloud 2 is all-invalid; every 5th
    frame is x_valid=False. Hand-scale clusters sit inside the clouds."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    F = G * L
    y = rng.normal(scale=0.05, size=(G, P2, 3))
    for k, off in enumerate((1, 32, 256, 1024, 2048, 4096)):
        j = np.arange(k, max(P2 - off, 0), 7)
        y[:, j + off] = y[:, j]
    x = rng.normal(scale=0.03, size=(F, P1, 3)) + rng.normal(scale=0.02, size=(F, 1, 3))
    i = np.arange(max(P1 - 128, 0))
    i = i[(i // 128) % 2 == 0]
    x[:, i + 128] = x[:, i]
    i = np.arange(5, P1 - 1, 16)
    x[:, i + 1] = x[:, i]
    i = np.arange(2, P1 - 8, 32)
    x[:, i + 8] = x[:, i]
    n = rng.normal(size=(F, P1, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    yv = np.ones((G, P2), bool)
    if G > 1:
        yv[1, rng.integers(0, P2 + 1):] = False
    if G > 2:
        yv[2] = False
    xv = np.ones(F, bool)
    xv[::5] = False
    og = rng.normal(size=(F, P2)) * 0.01
    hg = np.abs(rng.normal(size=(F, P1))) * 0.01
    vw = rng.random(P1)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    return (f32(x), f32(n), f32(y), torch.from_numpy(yv).cuda(), torch.from_numpy(xv).cuda(),
            f32(og), f32(hg), f32(vw))


def has_copy(p, valid):
    """[B, P] bool: point p[b, k] (of [B, P, 3]) equals another point of its
    set; with `valid` [B, P], only valid points count, on both sides."""
    import torch

    out = torch.zeros(p.shape[:2], dtype=torch.bool, device=p.device)
    for b in range(p.shape[0]):
        keep = torch.ones(p.shape[1], dtype=torch.bool, device=p.device) if valid is None else valid[b]
        if not bool(keep.any()):
            continue
        _, inv, cnt = torch.unique(p[b][keep], dim=0, return_inverse=True, return_counts=True)
        out[b, keep] = cnt[inv] > 1
    return out


def check_signed_edges() -> None:
    """#6 and #8 against their plain versions on tie_scene at ragged sizes:
    P1 in {1, 37, 778, MAX_ROWS} (#8: its own MAX_ROWS), P2 in {1, 1000,
    8192, 8193}, y_group 1 and 8 (3 clouds: one ragged, one all-invalid),
    x_valid=False frames for #8. #6 equal (values and first-min indices),
    #8 at dist_loss's checks (rtol 1e-6 / atol 1e-7, gx_do per frame);
    an all-invalid cloud's rows give BIG, never inf."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    t0 = time.perf_counter()
    names = ("h2o_d", "h2o_i", "o2h_d", "o2h_i", "o2h_dot")
    err8, ties, cases = 0.0, [0, 0], 0
    for L in (1, 8):
        for P1 in (1, 37, 778, CS.MAX_ROWS):
            for P2 in (1, 1000, 8192, 8193):
                x, n, y, yv, xv, og, hg, vw = tie_scene(3, L, P1, P2, seed=P1 + P2 + L)
                where = f"P1={P1} P2={P2} y_group={L}"
                ops = CS.prepare(x, y, n, yv, L)
                got = CS.launch(*ops, L)
                want = CS.plain(*ops, L)
                for nm, a, w in zip(names, got, want):
                    require(torch.equal(a, w), f"nn_signed {nm} differs from the plain version at {where}")
                dead = ~yv.any(dim=1).repeat_interleave(L)
                require(bool((got[0][dead] == CS.BIG).all()), f"nn_signed: all-invalid rows not BIG at {where}")
                # minima that tie: a row's nearest point has an exact valid copy,
                # a valid column's nearest row has an exact copy
                rows = torch.arange(x.shape[0], device="cuda")[:, None]
                ties[0] += int(has_copy(ops[2][..., :3], yv).repeat_interleave(L, 0)[rows, got[1].long()][~dead].sum())
                ties[1] += int((has_copy(ops[0], None)[rows, got[3].long()] & yv.repeat_interleave(L, 0)).sum())
                cases += 1
                if P1 > CL.MAX_ROWS:
                    continue
                lops = CL.prepare(x, n, y, og, hg, vw, yv, xv, L)
                got = CL.launch(*lops, L)
                want = CL.plain(*lops, L)
                for nm, i in (("v", 0), ("dh", 1), ("gx_dh", 3)):
                    require(torch.allclose(got[i], want[i], rtol=1e-6, atol=1e-7),
                            f"dist_loss {nm} vs plain at {where}: {(got[i] - want[i]).abs().max().item()}")
                require(scatter_close(got[2], want[2]), f"dist_loss gx_do vs plain at {where}")
                require(all(bool((a[~xv] == 0).all()) for a in got), f"dist_loss: x_valid=False not zero at {where}")
                err8 = max(err8, *((a - w).abs().max().item() for a, w in zip(got, want)))
                cases += 1
    torch.cuda.synchronize()
    require(min(ties) > 0, f"the tie scenes tie no minimum: {ties}")
    print(f"nn_signed and dist_loss on the tie scenes: {cases} cases, #6 equal to plain ({ties[0]} h2o and "
          f"{ties[1]} o2h minima tied), #8 within tolerance (max abs err {err8}), in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def kept_pairs(mask, yv, tile: int, L: int, P1: int = 778) -> float:
    """The (real row, valid point) pairs of the blocks a region-cull mask
    [F, R, T] keeps (it keeps nothing of x_valid=False frames): #9's work."""
    import torch

    F, R, T = mask.shape
    rows = torch.tensor([min(128, P1 - 128 * r) for r in range(R)], device=mask.device, dtype=torch.float64)
    pts = torch.stack([yv[:, t * tile : (t + 1) * tile].sum(dim=1) for t in range(T)], dim=1)  # [G, T]
    kept = (mask != 0).double() * rows[None, :, None]
    return float((kept * pts.repeat_interleave(L, dim=0)[:, None, :].double()).sum())


def mask_shares(mask, xv) -> tuple[float, float]:
    """Run share (flags != 0) and candidate share (flags >= 2) of a
    region-cull mask over the x_valid frames."""
    m = mask[xv]
    return (m != 0).double().mean().item(), (m >= 2).double().mean().item()


def check_cull_loss_kernel() -> dict[str, dict]:
    """#9 dist_loss_cull on the G main path's operands: training_scene at
    40960 frames (256 clouds x 160, y_group 160), its hand clusters laid
    out so that the template permutation gathers each into one 128-row
    region (as it makes a hand's regions compact), then permuted as
    chamfer_dist_loss(x_perm=) permutes rows, normals, h2o_g and vw; group
    1 ragged, group 2 the all-zero padded slot, group 3 all-invalid, every
    7th frame x_valid=False; mask tile 2048 (_clamp_tile(2048, 8192)).
    - against plain_cull on the 5120 frames (1/8) it is timed on: v, dh and
      gx_dh within #8's check's tolerance (rtol 1e-6 / atol 1e-7: one ulp of
      a sqrt or a division), gx_do within 1e-5 per frame (atomics);
    - against #8 on the same operands: v, dh and gx_dh bit-equal on live
      frames whose cloud has a valid point, gx_do within 1e-5 per frame;
      zeros elsewhere;
    - timed with the mask stage, #8 on the same operands and the plain
      version (8 x the time on 1/8 of the frames); its bound counts the
      (real row, valid point) pairs of the blocks the mask keeps."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL

    out = {}
    L, tile = TRAIN_L, 2048
    x, n, y, yv, xv, og, hg, vw = training_scene(TRAIN_CLOUDS, L, seed=16)
    yv[3] = False
    perm = torch.as_tensor(_r_geometry(torch.device("cuda"))[0].template_perm, device="cuda")
    inv = torch.argsort(perm)
    x, n, hg, vw = x[:, inv], n[:, inv], hg[:, inv], vw[inv]  # the clusters in template order
    x, n, hg, vw = x[:, perm], n[:, perm], hg[:, perm], vw[perm]  # what chamfer_dist_loss hands on
    F, P1, _ = x.shape
    G, P2 = y.shape[:2]
    mask = CL.region_cull_mask(x, y, yv, tile, L, xv)
    ops = CL.prepare(x, n, y, og, hg, vw, yv, xv, L)
    got = CL.launch_cull(*ops, mask, L, tile)
    torch.cuda.synchronize()
    f8, g8 = F // 8, G // 8
    part = [ops[0][:f8], ops[1][:f8], ops[2][:g8], ops[3][:g8], ops[4][:f8], ops[5][:f8], ops[6], ops[7][:f8]]
    want, plain_ms = cuda_timed(lambda: CL.plain_cull(*part, mask[:f8], L, tile))
    err = 0.0
    for nm, i in (("v", 0), ("dh", 1), ("gx_dh", 3)):
        a, b = got[i][:f8], want[i]
        require(torch.allclose(a, b, rtol=1e-6, atol=1e-7), f"dist_loss_cull {nm} vs plain: {(a - b).abs().max().item()}")
        err = max(err, (a - b).abs().max().item())
    require(scatter_close(got[2][:f8], want[2]), f"dist_loss_cull gx_do vs plain: {(got[2][:f8] - want[2]).abs().max().item()}")
    err = max(err, (got[2][:f8] - want[2]).abs().max().item())
    bit = all(torch.equal(got[i][:f8], want[i]) for i in (0, 1, 3))
    del want, part
    print(f"dist_loss_cull F={f8} P1={P1} P2={P2} y_group={L}: plain within tolerance (max abs err {err}; "
          f"v, dh, gx_dh bit-equal: {bit})", flush=True)
    full = CL.launch(*ops, L)
    torch.cuda.synchronize()
    live = xv & yv.any(dim=1).repeat_interleave(L)
    for nm, i in (("v", 0), ("dh", 1), ("gx_dh", 3)):
        require(torch.equal(got[i][live], full[i][live]), f"dist_loss_cull and dist_loss {nm} differ on live frames")
    require(scatter_close(got[2][live], full[2][live]), "dist_loss_cull and dist_loss gx_do differ on live frames")
    require(all(bool((a[~live] == 0).all()) for a in got), "dist_loss_cull: a frame that searched nothing is not zero")
    del full
    pairs = kept_pairs(mask, yv, tile, L, P1)
    run, cand = mask_shares(mask, xv)
    print(f"dist_loss_cull: v, dh, gx_dh bit-equal to dist_loss on the {int(live.sum())} live frames with a "
          f"valid point (gx_do within 1e-5 per frame), zeros elsewhere; mask (tile {tile}) over the "
          f"{int(xv.sum())} x_valid frames: run share {run:.4f}, candidate share {cand:.4f}; {pairs:.6g} pairs",
          flush=True)
    n_bytes = 2 * x.numel() * 4 + y.numel() * 4 + F * P2 * 8 + F * P1 * 8 + F * P1 * 24 + mask.numel() * 4
    b, by = bound_ms(n_bytes, pairs)
    out["dist_loss_cull"] = dict(
        kernel=CL.CULL_KERNEL, max_abs_err=err, shape=[F, P1, P2], run_share=run, candidate_share=cand,
        pairs=pairs,
        ms=cuda_time_ms(lambda: CL.launch_cull(*ops, mask, L, tile), reps=3),
        plain_ms=8 * plain_ms, library_ms=None, bound_ms=b, bound_by=by,
        mask_ms=cuda_time_ms(lambda: CL.region_cull_mask(x, y, yv, tile, L, xv), reps=3),
        all_pairs_ms=cuda_time_ms(lambda: CL.launch(*ops, L), reps=3),
    )
    o = out["dist_loss_cull"]
    print(f"dist_loss_cull F={F} P1={P1} P2={P2}: ms={o['ms']:.4f} plain_ms={o['plain_ms']:.3f} library_ms=none "
          f"bound_ms={b:.4f} ({by}) mask_ms={o['mask_ms']:.4f} dist_loss on the same operands "
          f"ms={o['all_pairs_ms']:.4f}; plain_ms: 8 x the time on 1/8 of the frames", flush=True)
    del x, n, y, yv, xv, og, hg, vw, ops, got, mask, live
    torch.cuda.empty_cache()
    return out


def drop_mask(F: int, P1: int, P2: int, tile: int, seed: int):
    """[F, R, T] int32 flags 0/1/3 on the card that drop ~40% of the blocks
    at random, region 1 of frame 3 everywhere and every block of frame 4."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    m = rng.choice(np.array([0, 1, 3], np.int32), size=(F, -(-P1 // 128), -(-P2 // tile)), p=[0.4, 0.3, 0.3])
    if F > 4:
        m[3, 1:2] = 0
        m[4] = 0
    return torch.from_numpy(m).cuda()


def check_cull_loss_edges() -> None:
    """#9 where its region gate and tile-clipped passes matter:
    - tie_scene (exact copies at the seams of the single-pass search) at
      tiles 2048, 512 and 640 (a tile's last pass runs partly on dead
      columns), P1 778 / P2 8193 at y_group 8 and P1 37 / P2 1000 at
      y_group 1, under masks that drop blocks at random: against
      plain_cull at #8's tolerances (v, dh, gx_dh rtol 1e-6 / atol 1e-7,
      gx_do 1e-5 per frame); x_valid=False frames and frames whose every
      block is dropped zero;
    - a separated scene (clustered rows, a cloud whose far half holds no
      minimum) whose exact mask keeps well under all blocks: against
      plain_cull, and v, dh, gx_dh bit-equal to #8 on live frames."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL

    t0 = time.perf_counter()
    err, cases = 0.0, 0
    for tile in (2048, 512, 640):
        for P1, P2, L in ((778, 8193, 8), (37, 1000, 1)):
            x, n, y, yv, xv, og, hg, vw = tie_scene(3, L, P1, P2, seed=tile + P1)
            where = f"tile={tile} P1={P1} P2={P2} y_group={L}"
            ops = CL.prepare(x, n, y, og, hg, vw, yv, xv, L)
            mask = drop_mask(x.shape[0], P1, P2, tile, seed=tile + P2)
            got = CL.launch_cull(*ops, mask, L, tile)
            want = CL.plain_cull(*ops, mask, L, tile)
            for nm, i in (("v", 0), ("dh", 1), ("gx_dh", 3)):
                require(torch.allclose(got[i], want[i], rtol=1e-6, atol=1e-7),
                        f"dist_loss_cull {nm} vs plain on the tie scene at {where}: "
                        f"{(got[i] - want[i]).abs().max().item()}")
            require(scatter_close(got[2], want[2]), f"dist_loss_cull gx_do vs plain on the tie scene at {where}")
            dead = ~xv | (mask == 0).flatten(1).all(dim=1)
            require(all(bool((a[dead] == 0).all()) for a in got), f"dist_loss_cull: a frame that searched nothing "
                    f"is not zero at {where}")
            err = max(err, *((a - w).abs().max().item() for a, w in zip(got, want)))
            cases += 1
    rng = np.random.default_rng(21)
    G, L, P2 = 4, 8, 8192
    F = G * L
    centers = rng.normal(scale=0.08, size=(F, 7, 3))
    x = centers[:, np.minimum(np.arange(778) // 128, 6)] + rng.normal(scale=0.01, size=(F, 778, 3))
    y = rng.normal(scale=0.06, size=(G, P2, 3))
    y[:, P2 // 2 :, 0] += 0.6  # a far half: its tiles hold no row's minimum
    yv = np.ones((G, P2), bool)
    yv[1, 6000:] = False
    yv[2] = False
    xv = np.ones(F, bool)
    xv[::5] = False
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    x, y = t(x), t(y)
    n = torch.nn.functional.normalize(t(rng.normal(size=(F, 778, 3))), dim=-1)
    og, hg = t(rng.normal(size=(F, P2)) * 0.01), t(np.abs(rng.normal(size=(F, 778))) * 0.01)
    yv, xv = torch.from_numpy(yv).cuda(), torch.from_numpy(xv).cuda()
    ops = CL.prepare(x, n, y, og, hg, torch.rand(778, device="cuda"), yv, xv, L)
    mask = CL.region_cull_mask(x, y, yv, 2048, L, xv)
    run, _ = mask_shares(mask, xv & yv.any(dim=1).repeat_interleave(L))
    require(0 < run < 0.8, f"the separated scene's mask keeps {run} of its blocks")
    got = CL.launch_cull(*ops, mask, L, 2048)
    want = CL.plain_cull(*ops, mask, L, 2048)
    for i in (0, 1, 3):
        require(torch.allclose(got[i], want[i], rtol=1e-6, atol=1e-7), "dist_loss_cull vs plain on the separated scene")
    require(scatter_close(got[2], want[2]), "dist_loss_cull gx_do vs plain on the separated scene")
    full = CL.launch(*ops, L)
    live = xv & yv.any(dim=1).repeat_interleave(L)
    require(all(torch.equal(got[i][live], full[i][live]) for i in (0, 1, 3)),
            "dist_loss_cull and dist_loss differ on the separated scene's live frames")
    torch.cuda.synchronize()
    print(f"dist_loss_cull on the tie scenes: {cases} cases (tiles 2048, 512, 640; masks dropping ~40% of the "
          f"blocks), within tolerance of plain (max abs err {err}), frames that searched nothing zero; separated "
          f"scene F={F} P2={P2}: run share {run:.4f} on its live frames, equal to plain and bit-equal to "
          f"dist_loss on them; in {time.perf_counter() - t0:.1f} s", flush=True)


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
    versions), on the fused, composed and fused_cull routes (#9 launches
    once on the GPU, never on the CPU): the same weights, batch, t and
    noise, dropout 0. Loss within
    rtol 1e-4; each parameter's clipped gradient within 2e-3 of its norm
    (+1e-6): fp32 GPU vs CPU matmul order through MANO, the kernels' atomics
    and a 1-layer transformer."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL

    cfg = MDMConfig(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
    rng = np.random.default_rng(6)
    noise = torch.from_numpy(rng.normal(size=(4, 16, 99)).astype(np.float32))
    t = torch.tensor([0, 10, 500, 999])
    for impl in ("fused", "composed", "fused_cull"):
        res = {}
        for dev in ("cuda", "cpu"):
            clip = FrozenClipText(device=dev)
            db = _train_batch(4, 16, 2, 512, seed=5, clip=clip, device=dev)
            db.update(t=t.to(dev), t_weights=torch.ones(4, device=dev))
            state, step, _ = _g_training(torch.device(dev), cfg, impl)
            before = CL.CULL_KERNEL.launches
            m = step(state, db, noise=noise.to(dev))
            if impl == "fused_cull":
                ran = CL.CULL_KERNEL.launches - before
                require(ran == (dev == "cuda"), f"small train step (fused_cull, {dev}): {ran} dist_loss_cull launches")
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


def train_main_path(dist_impl: str = "auto", state=None, db=None):
    """G training at full width: arch_mdm_l, batch 64 x 160 frames x 4
    objects x 8192 points, 1000-step cosine schedule, on `dist_impl`
    ("auto" = the fused route builds the model and batch; "fused_cull"
    reuses them); one warm-up step, then 3 timed steps with the launch
    counts set to 0 just before: #6 (GT side) and the route's loss kernel
    (#8, or #9 on fused_cull) once per step, #7 never; then the split of a
    step on the same batch, with, on fused_cull, the mask stage and #9 and
    #8 alone on the step's own operands and the mask's shares there."""
    import torch

    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.core import geometry as TG
    from oakink2_tamf_tpu_torch.core import transforms as T
    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
    from oakink2_tamf_tpu_torch.models.refine_r import batch_recover_mano
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS
    from oakink2_tamf_tpu_torch.parallel import train as PT

    dev = torch.device("cuda")
    cull = dist_impl == "fused_cull"
    label = f"train main path ({'fused_cull' if cull else 'fused'})"
    t0 = time.perf_counter()
    if state is None:
        clip = FrozenClipText(device=dev)
        db = _train_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, TRAIN_P, seed=11, clip=clip, device=dev)
        state, step, mano = _g_training(dev, MDMConfig.arch_mdm_l(), dist_impl)
    else:
        mano, assets = _r_geometry(dev)
        step = PT.make_g_train_step(D.tamf_schedule(1000).to(dev), mano, assets, LL.ExtraLossConfig(),
                                    dist_impl=dist_impl)
    gen = torch.Generator(device=dev).manual_seed(2 if cull else 0)
    torch.cuda.synchronize()
    print(f"{label}: batch + model {time.perf_counter() - t0:.2f} s "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)", flush=True)
    t0 = time.perf_counter()
    step(state, db, generator=gen)
    torch.cuda.synchronize()
    print(f"{label}: warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    kernels = {"nn_signed": CS.KERNEL, "nn_signed_bwd": CS.BWD_KERNEL, "dist_loss": CL.KERNEL,
               "dist_loss_cull": CL.CULL_KERNEL}
    _zero_counts(kernels)
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
    print(f"{label}: steps {[round(x, 4) for x in times]} s, mean {step_s:.4f} s = "
          f"{TRAIN_BS / step_s:.3f} samples/s; losses {losses}; peak memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    require(all(v == v and abs(v) < float("inf") for v in losses), f"{label}: non-finite training loss")
    require(any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters())),
            f"{label}: parameters unchanged")
    loss_kernel, other = ("dist_loss_cull", "dist_loss") if cull else ("dist_loss", "dist_loss_cull")
    require(counts["nn_signed"] == 3, f"{label}: nn_signed launched {counts['nn_signed']} times in 3 steps")
    require(counts[loss_kernel] == 3, f"{label}: {loss_kernel} launched {counts[loss_kernel]} times in 3 steps")
    require(counts[other] == 0 and counts["nn_signed_bwd"] == 0, f"{label}: launches {counts}")
    del before

    # where the step's time goes, each piece alone on the same batch
    model, sched = state.model, D.tamf_schedule(1000).to(dev)
    cond = {k: db[k] for k in ("text_emb", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask")}
    t = torch.randint(0, 1000, (TRAIN_BS,), device=dev, generator=gen)
    vw = torch.rand(778, device=dev)

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

    def loss_pass():
        v = verts.clone().requires_grad_(True)
        do_f, dh_f = LL._dist_sums_fused(v, normals, transf, db["obj_points"], o2h_g, h2o_g, vw,
                                         seq_mask=db["mask"], obj_mask=db["obj_mask"], region_cull=cull,
                                         x_perm=mano.template_perm if cull else None)
        (do_f.sum() + dh_f.sum()).backward()

    split = {
        "G forward+backward": cuda_time_ms(g_fwd_bwd, reps=3),
        "MANO with normals (one hand batch)": cuda_time_ms(mano_normals, reps=3),
        "GT pass (nn_signed + prep)": cuda_time_ms(gt_pass, reps=2),
        ("fused_cull pass (perm + mask + dist_loss_cull fwd + bwd + prep)" if cull
         else "fused pass (dist_loss fwd + bwd + prep)"): cuda_time_ms(loss_pass, reps=2),
    }
    if cull:
        # the route's own operands: the hand in the canonical frames, permuted
        with torch.no_grad():
            x, n, y = LL._canonical_operands(verts, normals, transf, db["obj_points"])
        xv = ((db["mask"] > 0)[:, None, :] & db["obj_mask"].to(torch.bool)[:, :, None]).reshape(-1)
        perm = torch.as_tensor(mano.template_perm, device=dev)
        x, n = x[:, perm].contiguous(), n[:, perm].contiguous()
        tile = TG._clamp_tile(2048, TRAIN_P)
        mask = CL.region_cull_mask(x, y, None, tile, TRAIN_L, xv)
        ops = CL.prepare(x, n, y, o2h_g.reshape(-1, TRAIN_P), h2o_g.reshape(-1, 778)[:, perm], vw[perm],
                         None, xv, TRAIN_L)
        run, cand = mask_shares(mask, xv)
        pairs = kept_pairs(mask, torch.ones(y.shape[:2], dtype=torch.bool, device=dev), tile, TRAIN_L)
        print(f"{label}: the step's mask (tile {tile}) over its {int(xv.sum())} x_valid frames: run share "
              f"{run:.4f}, candidate share {cand:.4f}; {pairs:.6g} pairs kept of "
              f"{float(xv.sum()) * 778 * TRAIN_P:.6g}", flush=True)
        split["mask stage (region_cull_mask)"] = cuda_time_ms(
            lambda: CL.region_cull_mask(x, y, None, tile, TRAIN_L, xv), reps=3)
        split["dist_loss_cull alone"] = cuda_time_ms(lambda: CL.launch_cull(*ops, mask, TRAIN_L, tile), reps=3)
        split["dist_loss alone on the same operands"] = cuda_time_ms(lambda: CL.launch(*ops, TRAIN_L), reps=3)
        del x, n, y, ops, mask
    else:
        # #8 and #6 alone on the step's own operands (33.9% of the rows live)
        with torch.no_grad():
            x, n, y = LL._canonical_operands(verts, normals, transf, db["obj_points"])
        xv = ((db["mask"] > 0)[:, None, :] & db["obj_mask"].to(torch.bool)[:, :, None]).reshape(-1)
        ops = CL.prepare(x, n, y, o2h_g.reshape(-1, TRAIN_P), h2o_g.reshape(-1, 778), vw, None, xv, TRAIN_L)
        split["dist_loss alone"] = cuda_time_ms(lambda: CL.launch(*ops, TRAIN_L), reps=3)
        ops = CS.prepare(x, y, n, None, TRAIN_L)  # the GT pass's #6 on the same canonical operands
        split["nn_signed alone"] = cuda_time_ms(lambda: CS.launch(*ops, TRAIN_L), reps=3)
        del x, n, y, ops
    split["optimizer (clip + AdamW + LR)"] = cuda_time_ms(state.optimizer.step, reps=3)
    print(f"{label} step split (ms, each alone on the same batch): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    del verts, normals, transf, o2h_g, h2o_g
    torch.cuda.empty_cache()
    return state, db, counts, step_s


def composed_route(state, db):
    """The same model and batch on dist_impl="composed", 2 steps: the
    signed forward runs on both sides, its backward kernel on the
    predicted side. Then a third step, untimed, keeps #7's operands, and
    #7 is timed on them (the rows per warp its scatter meets there)."""
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
    with kept_arguments(CS, "backward_launch") as kept:  # one more step, untimed: #7's operands
        step(state, db, generator=gen)
    args = kept[-1]  # (x, y, h2o_i, o2h_i, xr, yc, grad_y, y_group)
    rpw = rows_per_warp(args[3], args[5])
    ms = cuda_time_ms(lambda: CS.backward_launch(*args), reps=10)
    print(f"nn_signed_bwd on the composed step's own operands (F={args[0].shape[0]} P2={args[1].shape[1]} "
          f"y_group={args[7]}, {int((args[5] != 0).sum())} live points): {ms:.4f} ms; distinct rows per 32 live "
          f"points {rpw:.4f}", flush=True)
    return counts


@contextlib.contextmanager
def kept_arguments(module, name: str):
    """with kept_arguments(module, name) as kept: calls of module.name made
    inside the block (through the module's global, as its callers make
    them) keep their arguments in `kept`, in order."""
    fn, kept = getattr(module, name), []

    def keep(*args):
        kept.append(args)
        return fn(*args)

    setattr(module, name, keep)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def composed_bwd_operands():
    """Kernel #7's operands in one composed G step at full width (arch_mdm_l,
    the G main path's batch and seeds): (x, y, h2o_i, o2h_i, xr, yc,
    grad_y, y_group)."""
    import torch

    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    dev = torch.device("cuda")
    db = _train_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, TRAIN_P, seed=11, clip=FrozenClipText(device=dev), device=dev)
    state, step, _ = _g_training(dev, MDMConfig.arch_mdm_l(), "composed")
    with kept_arguments(CS, "backward_launch") as kept:
        step(state, db, generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    return kept[-1]


def entry_point(dist_impl: str = "auto") -> None:
    """launch/train_g.main on the synthetic smoke config, on the card, with
    --train.dist_impl `dist_impl`: #6 and the route's loss kernel (#8, or
    #9 on fused_cull) once per step, the other loss kernel never."""
    import torch

    from oakink2_tamf_tpu_torch.launch import train_g
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    root = os.path.dirname(os.path.abspath(__file__))
    loss, other = (CL.CULL_KERNEL, CL.KERNEL) if dist_impl == "fused_cull" else (CL.KERNEL, CL.CULL_KERNEL)
    CS.KERNEL.launches = loss.launches = other.launches = 0
    t0 = time.perf_counter()
    state = train_g.main(["--cfg", os.path.join(root, "config/synthetic_smoke.yml"), "--exp_id",
                          f"chip_smoke_{dist_impl}", "--train.dist_impl", dist_impl])
    torch.cuda.synchronize()
    require(state.step == 4, f"train_g.main took {state.step} steps, expected 4")
    require(all(torch.isfinite(p).all() for p in state.model.parameters()), "train_g.main: non-finite weights")
    require(next(state.model.parameters()).is_cuda, "train_g.main did not run on the card")
    print(f"train_g.main (synthetic_smoke.yml, cuda, dist_impl {dist_impl}): 2 epochs, {state.step} steps in "
          f"{time.perf_counter() - t0:.2f} s; launches nn_signed {CS.KERNEL.launches} {loss.name} "
          f"{loss.launches} {other.name} {other.launches}", flush=True)
    require(CS.KERNEL.launches == 4 and loss.launches == 4 and other.launches == 0,
            f"train_g.main (dist_impl {dist_impl}) did not run the route's kernels")


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
    tile = CU.DEFAULT_TILE
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
            # atomics sum in a run-dependent order: both within the float32 sum bound
            ex = backward_exact(x, yy, None, None, idx, xr)[1]
            share5 = max(gy_sum_bound_share(gy, ex), gy_sum_bound_share(py, ex))
            require(share5 <= 1.0, f"h2o_nn_bwd gy vs plain: {(gy - py).abs().max().item()}, "
                    f"{share5} of the float32 sum bound")
            err5 = (gy - py).abs().max().item()
            del ex
    print(f"h2o_nn_bwd nogy (y_group {L}) and grad_y ({TRAIN_P} points, {TRAIN_P * 12 // 1024} KB "
          f"accumulator): gx equal, gy and plain within {share5:.4g} of the float32 sum bound (max abs "
          f"err {err5})", flush=True)
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
            # #2 and #3 at the mask tiles 2048..128 (#2 at the R shape too);
            # the numbers at the shipped tile and at 2048 from there
            sweep = tile_sweep("chip_smoke's R shape", x, y, yv, xv, L)
            extra = dict(cull_stats(sweep, "dvec_ms"), h2o_cull=cull_stats(sweep, "cull_ms"))
            mask = CU.cull_mask(x, y, yv, tile, L, xv)
            kernel, run = CU.DVEC_KERNEL, (lambda: CU.launch_dvec(*ops, mask, L, tile))
            plain = (lambda: CU.plain_dvec(ops[0][: part[0]], ops[1][: part[1]], ops[2][: part[1]],
                                           mask[: part[0]], L, tile))
        else:
            # the prepared operands and the cell flags read once, d and dvec
            # written once; each row against each valid point of its cloud
            w = all_pairs_work(yv, L, P1)
            n_bytes = sum(t.numel() * 4 for t in ops) + TRAIN_CLOUDS * (-(-P2 // 128)) + F * P1 * 16
            kernel, run = NN.DVEC_KERNEL, (lambda: NN.launch_dvec(*ops, L))
            plain = lambda: NN.plain_dvec(ops[0][: part[0]], ops[1][: part[1]], ops[2][: part[1]], L)  # noqa: E731
            b, by = bound_ms(n_bytes, w["pairs"])
            extra = dict(ms=cuda_time_ms(run, reps=3), bound_ms=b, bound_by=by, **w)
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
            plain_ms=8 * cuda_time_ms(plain, reps=1, warmup=0),
            library_ms=cuda_time_ms(lambda: library_min_dvec(xc, yc), reps=1),
            **extra,
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
    ex = backward_exact(x, yy, None, None, idx, xr)[1]
    share5 = max(gy_sum_bound_share(gy, ex), gy_sum_bound_share(py, ex))
    require(torch.equal(gx, px) and share5 <= 1.0,
            f"h2o_nn_bwd differs from the plain version at F={F} P2={P2}: gy {(gy - py).abs().max().item()}, "
            f"{share5} of the float32 sum bound")
    err5 = max(err5, (gy - py).abs().max().item())
    print(f"h2o_nn_bwd F={F} P1={P1} P2={P2} y_group 1: gx equal, gy and plain within {share5:.4g} of the "
          f"float32 sum bound (max abs err {(gy - py).abs().max().item()}; worst frame's sum|terms| / |gy| "
          f"{cancellation(ex):.4g})", flush=True)
    del gx, gy, px, py, ex
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
        rf = (f" (tile {tile}; at tile 2048 {o['ms_2048']:.4f}) kept share={o['kept_share']:.4f} "
              f"mask_ms={o['mask_ms']:.4f}" if "ms_2048" in o else "")
        if "cell_share" in o:
            rf = (f" ({o['pairs']:.6g} valid pairs, {o['searched']:.6g} searched, cells with a valid point "
                  f"{o['cell_share']:.4f})")
        print(f"{name} F={F} P1={P1} P2={P2}: ms={o['ms']:.4f}{rf} plain_ms={o['plain_ms']:.3f} "
              f"library_ms={o['library_ms']:.3f} bound_ms={o['bound_ms']:.4f} ({o['bound_by']})", flush=True)
    F, P1, P2 = out["h2o_cull_dvec"]["shape"]
    o = out["h2o_cull_dvec"]["h2o_cull"]
    print(f"h2o_cull at the R shape F={F} P1={P1} P2={P2}: ms={o['ms']:.4f} (tile {tile}; at tile 2048 "
          f"{o['ms_2048']:.4f}) bound_ms={o['bound_ms']:.4f} ({o['bound_by']})", flush=True)
    print("plain_ms of h2o_cull_dvec and h2o_nn_dvec: 8 x the time on 1/8 of the frames", flush=True)
    del x, yy, yv, idx, xr, srt
    torch.cuda.empty_cache()
    return out


def cull_scene(seed: int = 0, G: int = 4, L: int = 3, P1: int = 778, P2: int = 4000):
    """(x, y, y_valid, x_valid, y_group) on the card, made with numpy:
    hand-sized 128-row clusters near spatially sorted clouds; cloud 0 has
    exact copies of every 7th point at +1 (the same cell), +128 and +256
    (the next cells), so minima tie across cells; cloud 1 is ragged, cloud
    2 all-invalid, cloud 3 sits 0.3 m away; frames 1 and 7 are
    x_valid=False. 778 rows (a 10-row last region), 4000 points (a 32-point
    last cell)."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.utils.pc_util import spatial_sort_indices

    rng = np.random.default_rng(seed)
    y = rng.normal(scale=0.05, size=(G, P2, 3))
    for g in range(G):
        y[g] = y[g][spatial_sort_indices(y[g])]
    j = np.arange(0, P2 - 256, 7)
    for off in (1, 128, 256):
        y[0, j + off] = y[0, j]
    y[3] += np.array([0.3, 0.0, 0.0])
    F = G * L
    centers = rng.normal(scale=0.05, size=(F, 7, 3))
    x = centers[:, np.minimum(np.arange(P1) // 128, 6)] + rng.normal(scale=0.01, size=(F, P1, 3))
    yv = np.ones((G, P2), bool)
    yv[1, P2 // 3 :] = False
    yv[2] = False
    xv = np.ones(F, bool)
    xv[[1, 7]] = False
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    return f32(x), f32(y), torch.from_numpy(yv).cuda(), torch.from_numpy(xv).cuda(), L


def check_cull_edges() -> None:
    """#2 and #3 on cull_scene at tiles 128, 640 and 2048: under the scene's
    own mask and under masks that drop ~40% of the blocks (drop_mask), both
    bit-equal to their plain versions; under the own mask #3 at every tile
    bit-equal to #3 at tile 2048 and to #4 on live frames, #2 equal to #3's
    values; rows whose every block is dropped (BIG, 0)."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    t0 = time.perf_counter()
    x, y, yv, xv, L = cull_scene()
    F, P1, _ = x.shape
    P2 = y.shape[1]
    ops = NN.prepare(x, y, yv, L)
    live = xv & yv.any(dim=1).repeat_interleave(L)
    d4, dv4 = NN.launch_dvec(*ops, L)
    ref, shares, cases = None, [], 0
    for tile in (2048, 640, 128):
        for which in ("own", "drop"):
            mask = CU.cull_mask(x, y, yv, tile, L, xv) if which == "own" else drop_mask(F, P1, P2, tile, seed=tile)
            where = f"tile {tile}, {which} mask"
            d = CU.launch(*ops, mask, L, tile)
            d3, dv3 = CU.launch_dvec(*ops, mask, L, tile)
            require(torch.equal(d, CU.plain(*ops, mask, L, tile)), f"h2o_cull differs from plain at {where}")
            pd, pdv = CU.plain_dvec(*ops, mask, L, tile)
            require(torch.equal(d3, pd) and torch.equal(dv3, pdv), f"h2o_cull_dvec differs from plain at {where}")
            require(torch.equal(d, d3), f"h2o_cull and h2o_cull_dvec values differ at {where}")
            cases += 1
            if which == "drop":
                require(bool((d3[4] == CU.BIG).all() and (dv3[4] == 0).all()),
                        f"h2o_cull_dvec: a frame whose blocks are all dropped is not (BIG, 0) at {where}")
                continue
            shares.append(f"{tile}: {cull_pairs(mask, P1, P2, tile) / (float(live.sum()) * P1 * P2):.4f}")
            ref = ref or (d3, dv3)
            require(torch.equal(d3, ref[0]) and torch.equal(dv3, ref[1]), f"h2o_cull_dvec at {where} differs from "
                    "tile 2048")
            require(torch.equal(d3[live], d4[live]) and torch.equal(dv3[live], dv4[live]),
                    f"h2o_cull_dvec and h2o_nn_dvec differ on live frames at {where}")
    xc = NN.centred_x(ops[0], ops[2], L)
    d2 = NN.sq_norm_rn(xc[:, :, None, :] - ops[1][..., :3].repeat_interleave(L, 0)[:, None])
    ties = int(((d2 == ref[0][..., None]).sum(-1) > 1)[live].sum())
    require(ties > 0, "the cull scene ties no minimum")
    torch.cuda.synchronize()
    print(f"h2o_cull / h2o_cull_dvec on the cull scene (F={F} P1={P1} P2={P2} y_group {L}; {ties} live rows whose "
          f"minimum two points reach): {cases} cases (tiles 2048, 640, 128; own masks, kept share "
          f"{', '.join(shares)}; masks dropping ~40% of the blocks) bit-equal to plain; #3 the same at every tile "
          f"and equal to h2o_nn_dvec on live frames; in {time.perf_counter() - t0:.1f} s", flush=True)


def nn_scene(seed: int = 0, G: int = 4, L: int = 3, P1: int = 778, P2: int = 2000):
    """(x, y, y_valid, x_valid, y_group) on the card, made with numpy: the
    tie scene of the all-pairs searches (tests/test_torch_nn_cells.py).
    Hand-sized 128-row clusters near spatially sorted clouds; clouds 0 and
    3 have exact copies of every 7th point at +1, +128 and +256; cloud 1 is
    ragged, cloud 2 all-invalid, cloud 3's cell 7 all-invalid with valid
    cells after it; frames 1 and 10 are x_valid=False. 778 rows (a 10-row
    last region), 2000 points (an 80-point last cell)."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.utils.pc_util import spatial_sort_indices

    rng = np.random.default_rng(seed)
    y = rng.normal(scale=0.05, size=(G, P2, 3))
    for g in range(G):
        y[g] = y[g][spatial_sort_indices(y[g])]
    j = np.arange(0, P2 - 256, 7)
    for off in (1, 128, 256):
        for g in (0, 3):
            y[g, j + off] = y[g, j]
    F = G * L
    centers = rng.normal(scale=0.05, size=(F, 7, 3))
    x = centers[:, np.minimum(np.arange(P1) // 128, 6)] + rng.normal(scale=0.01, size=(F, P1, 3))
    yv = np.ones((G, P2), bool)
    yv[1, P2 // 3 :] = False
    yv[2] = False
    yv[3, 7 * 128 : 8 * 128] = False
    xv = np.ones(F, bool)
    xv[[1, 10]] = False
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()  # noqa: E731
    return f32(x), f32(y), torch.from_numpy(yv).cuda(), torch.from_numpy(xv).cuda(), L


def check_nn_edges() -> None:
    """#1 and #4 on nn_scene at y_group 3 and 1 (one cloud per frame):
    values, first-min indices and dvec bit-equal to their plain versions
    (the full search); #4's values equal #1's; #4 equal to #3 (its own mask
    at the shipped tile) on live frames; x_valid=False frames searched."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    t0 = time.perf_counter()
    x, y, yv, xv, L = nn_scene()
    ties = 0
    for gl in (L, 1):
        yy, yyv = (y, yv) if gl == L else (y.repeat_interleave(L, 0).contiguous(), yv.repeat_interleave(L, 0))
        ops = NN.prepare(x, yy, yyv, gl)
        d, idx = NN.launch(*ops, gl)
        d4, dvec = NN.launch_dvec(*ops, gl)
        pd, pidx = NN.plain(*ops, gl)
        pd4, pdvec = NN.plain_dvec(*ops, gl)
        where = f"the all-pairs tie scene, y_group {gl}"
        require(torch.equal(d, pd) and torch.equal(idx, pidx), f"h2o_nn differs from plain on {where}")
        require(torch.equal(d4, pd4) and torch.equal(dvec, pdvec), f"h2o_nn_dvec differs from plain on {where}")
        require(torch.equal(d, d4), f"h2o_nn and h2o_nn_dvec values differ on {where}")
        took = yyv.any(1).repeat_interleave(gl)
        require(bool((d[~xv & took] < NN.BIG).all()), f"h2o_nn: x_valid=False frames not searched on {where}")
        if gl == L:
            d3, dv3 = CU.launch_dvec(*ops, CU.cull_mask(x, y, yv, CU.DEFAULT_TILE, L, xv), L, CU.DEFAULT_TILE)
            live = xv & took
            require(torch.equal(d3[live], d4[live]) and torch.equal(dv3[live], dvec[live]),
                    "h2o_nn_dvec and h2o_cull_dvec differ on live frames of the all-pairs tie scene")
            xc = NN.centred_x(ops[0], ops[2], L)
            d2 = NN.sq_norm_rn(xc[:, :, None, :] - ops[1][..., :3].repeat_interleave(L, 0)[:, None])
            ties = int(((d2 == d[..., None]).sum(-1) > 1)[took].sum())
            require(ties > 0, "the all-pairs tie scene ties no minimum")
    torch.cuda.synchronize()
    print(f"h2o_nn / h2o_nn_dvec on the all-pairs tie scene (F={x.shape[0]} P1={x.shape[1]} P2={y.shape[1]}, "
          f"y_group {L} and 1; {ties} rows whose minimum two points reach; an invalid middle cell, a ragged and an "
          f"all-invalid cloud, x_valid=False frames): values, indices and dvec bit-equal to plain; #4 equal to #3 "
          f"on live frames; in {time.perf_counter() - t0:.1f} s", flush=True)


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


def all_pairs_work(yv, L: int, P1: int) -> dict:
    """The work of #1/#4 on clouds with validity yv [G, P2], y_group L, P1
    rows: `pairs`, each real row against each valid point of its cloud (the
    bound's work); `searched`, the pairs the cell search walks (the rows of
    each 128-row region rounded up to a multiple of 32, against the 128
    points of every cell that holds a valid point); `cell_share`, the cells
    with a valid point over all cells."""
    import torch

    G, P2 = yv.shape
    C = -(-P2 // 128)
    cells = torch.nn.functional.pad(yv, (0, C * 128 - P2)).reshape(G, C, 128).any(-1)
    rows = sum(32 * -(-min(128, P1 - r0) // 32) for r0 in range(0, P1, 128))
    return dict(pairs=float(yv.sum()) * L * P1, searched=float(cells.sum()) * 128 * L * rows,
                cell_share=float(cells.float().mean()))


def r_train_main_path(route: str = "cull"):
    """R training at full width: arch_refine (dropout 0.1), batch 64 x 160
    frames x 4 objects, target_h2o from TargetH2OCache, sample from the
    Gaussian-perturb adaptor; on the cull route (8192 points: #2 and #3) or
    the all-pairs route (2048 points, the repo default cloud: #1 and #4).
    One warm-up step, then 3 timed steps with the counts set to 0 just
    before; then the split of a step on the same batch; then the kernels on
    the operands the step hands them, captured from one call: on the cull
    route the tile sweep of #3's, on the all-pairs route #1's (sample h2o)
    and #4's (refined h2o), each timed with its valid-cell share. Uses only
    the package's entry points and wrappers, so r_step_ab.py can run it on
    an earlier tree's package."""
    import torch

    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.refine_r import (
        RefineConfig, batch_recover_mano, multi_object_h2o_dist, refine_forward, sample_geometry,
        target_geometry,
    )
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    cull = route == "cull"
    require(route in ("cull", "all-pairs"), f"unknown R route {route}")
    P = TRAIN_P if cull else R_ALL_PAIRS_P
    label = f"R main path ({route} route, {P} points)"
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    state, step, mano, assets = _r_training(dev, RefineConfig(), "auto")
    db, pre = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, P, 11, mano, dev)
    torch.cuda.synchronize()
    print(f"{label}: model + batch {time.perf_counter() - t0:.2f} s, of which the target-h2o cache "
          f"precompute ({TRAIN_BS} segments on the card) {pre:.3f} s "
          f"({sum(p.numel() for p in state.model.parameters())} parameters)", flush=True)
    t0 = time.perf_counter()
    step(state, db)
    torch.cuda.synchronize()
    print(f"{label}: warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

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
    print(f"{label}: steps {[round(t, 4) for t in times]} s, mean {step_s:.4f} s = "
          f"{TRAIN_BS / step_s:.3f} samples/s; losses {losses}; peak memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    require(all(v == v and abs(v) < float("inf") for v in losses), f"{label}: non-finite training loss")
    require(any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters())),
            f"{label}: parameters unchanged")
    # once per step each: the sample geometry's search and the refined one's
    sample_k, refined_k = ("h2o_cull", "h2o_cull_dvec") if cull else ("h2o_nn", "h2o_nn_dvec")
    for name in kernels:
        want = 3 if name in (sample_k, refined_k) else 0
        require(counts[name] == want, f"{label}: {name} launched {counts[name]} times in 3 steps, expected {want}")
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

    s_name, r_name = ("cull mask + h2o_cull", "cull mask + h2o_cull_dvec") if cull else ("h2o_nn", "h2o_nn_dvec")
    split = {
        "sample MANO with normals (no grad)": cuda_time_ms(sample_mano, reps=3),
        f"sample h2o ({s_name}, no grad)": cuda_time_ms(sample_h2o, reps=3),
        "R forward+backward": cuda_time_ms(r_fwd_bwd, reps=3),
        "refined MANO with normals forward+backward": cuda_time_ms(refined_mano, reps=3),
        f"refined h2o ({r_name}) forward+backward": cuda_time_ms(refined_h2o, reps=3),
        "loss forward+backward": cuda_time_ms(loss_pass, reps=3),
        "optimizer (clip + AdamW + LR)": cuda_time_ms(state.optimizer.step, reps=3),
    }
    print(f"{label.replace('main path', 'step split')} (ms, each alone on the same batch): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)

    # the operands the step hands its kernels, captured from one call
    seen = {}

    def capture(mod, fn_name, key, run):
        shipped = getattr(mod, fn_name)

        def wrapped(x, y, y_valid=None, *a, **kw):
            seen[key] = (x.detach(), y, y_valid, a, kw)
            return shipped(x, y, y_valid, *a, **kw)

        setattr(mod, fn_name, wrapped)
        try:
            run()
        finally:
            setattr(mod, fn_name, shipped)

    if cull:
        # #3's own operands (the refined h2o hands them to h2o_cull_dvec) at
        # the mask tiles 2048..128
        capture(CU, "h2o_cull_dvec", "dvec", refined_h2o)
        x, y, yv, _, kw = seen["dvec"]
        require(kw.get("x_valid") is not None and (kw.get("tile") is None), "R: unexpected h2o_cull_dvec call")
        tile_sweep("the R main path's refined h2o", x, y, yv, kw["x_valid"], kw["y_group"])
    else:
        # #1's (sample h2o) and #4's (refined h2o) own operands: times, the
        # share of cells with a valid point, the work and its bounds
        capture(NN, "h2o_nn", "nn", sample_h2o)
        capture(NN, "h2o_nn_dvec", "dvec", refined_h2o)
        for key, launch in (("nn", NN.launch), ("dvec", NN.launch_dvec)):
            x, y, yv, a, kw = seen[key]
            L = (a + (kw.get("y_group", 1),))[0]
            ops = NN.prepare(x, y, yv, L)
            F, P1, _ = x.shape
            w = all_pairs_work(yv if yv is not None else torch.ones(y.shape[:2], dtype=torch.bool, device=dev),
                               L, P1)
            ms = cuda_time_ms(lambda: launch(*ops, L), reps=5)
            b, _ = bound_ms(0, w["pairs"])
            name = "h2o_nn" if key == "nn" else "h2o_nn_dvec"
            print(f"{name} on the R step's own operands (F={F} P1={P1} P2={y.shape[1]} y_group={L}): {ms:.4f} ms; "
                  f"cells with a valid point {w['cell_share']:.4f}; {w['pairs']:.6g} valid pairs (bound {b:.4f} "
                  f"ms, issue floor {issue_floor_ms(w['pairs'], 7):.4f} ms), {w['searched']:.6g} searched by the "
                  f"cell search; {F * P1 * y.shape[1]:.6g} all pairs", flush=True)
            del ops
    seen.clear()
    del db, sg, res, tgt, s_verts, r_verts, r_pose
    torch.cuda.empty_cache()
    return state, counts, step_s


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
      with grad_y at 10240 frames x 778 x 2048 per-frame clouds (gx equal;
      gy and the plain version's within the float32 sum bound of the
      float64 sum, gy_sum_bound_share);
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
    # what the kernel searches: 128 rows x 128 points of each listed cell
    # with a valid point (it skips the others), against every listed cell
    searched = float(CC.cell_flags(y4)[cloud[:, None, None], cidx.long()].sum()) * S * S
    print(f"h2o_topk bound: {pairs10:.6g} pairs on {live_f} of {F} frames with a real object; the kernel "
          f"searches {searched:.6g} pairs (every listed cell: {F * T * K * S * S:.6g})", flush=True)
    del cell_pts, cloud
    xc = NN.centred_x(xs, ctr, L).reshape(G, L * P1, 3)
    yc = y4[..., :3].contiguous()
    out["h2o_topk"] = dict(
        kernel=CC.H2O_KERNEL, max_abs_err=err10, shape=[F, P1, P2], K=K, overflow_share=share, pairs=pairs10,
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
    ex = backward_exact(xg, yg, None, None, ig, xrg)[1]
    share11 = max(gy_sum_bound_share(gy, ex), gy_sum_bound_share(py, ex))
    require(torch.equal(gx, px) and share11 <= 1.0,
            f"h2o_topk_bwd (grad_y) differs from its plain version: gy {(gy - py).abs().max().item()}, "
            f"{share11} of the float32 sum bound")
    err11 = (gy - py).abs().max().item()
    print(f"h2o_topk_bwd nogy (F={F}, y_group {L}): gx equal to plain; grad_y (F={xg.shape[0]}, "
          f"P2={R_ALL_PAIRS_P}): gx equal, gy and plain within {share11:.4g} of the float32 sum bound "
          f"(max abs err {err11}; worst frame's sum|terms| / |gy| {cancellation(ex):.4g})", flush=True)
    del xg, yg, yvg, ig, xrg, gx, gy, px, py, ex
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
    # what the kernel searches: the 128 points of each cell with a valid
    # point (it skips the others) against the rows of every listed tile, the
    # last tile's rounded up to a 32-row segment (o2h_topk.cu's O2H_SEG)
    live12 = CC.cell_flags(y4F)
    walked = sum(min(CC.S_CELL, -(-(P1 - CC.S_CELL * t) // 32) * 32) for t in range(T))
    searched12 = float(live12.sum()) * CC.S_CELL * walked
    cell_share12 = float(live12.float().mean())
    del live12
    print(f"o2h_topk bound: {n_valid * P1:.6g} pairs, {n_valid} valid points on {live_f} of {F} frames; the "
          f"kernel searches {searched12:.6g} pairs (every cell: {F * C * CC.S_CELL * walked:.6g}), cells with a "
          f"valid point {cell_share12:.4f}", flush=True)
    xcF = NN.centred_x(xsF, ctrF, 1)
    ycF = y4F[..., :3]
    out["o2h_topk"] = dict(
        kernel=CC.O2H_KERNEL, max_abs_err=err12, shape=[F, P1, P2],
        pairs=float(n_valid * P1), searched=searched12, cell_share=cell_share12,
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
    rpw = rows_per_warp(o2h_i, ycot)
    print(f"o2h_topk_bwd F={F} P1={P1} P2={P2}: {n_live} live points; distinct rows per 32 consecutive live "
          f"points {rpw:.4f}", flush=True)
    out["o2h_topk_bwd"] = dict(
        kernel=CC.O2H_BWD_KERNEL, max_abs_err=err13, shape=[F, P1, P2], rows_per_warp=rpw,
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


def check_topk_edges() -> None:
    """#10 on a tie scene whose candidate lists are not in index order: 3
    clouds of 8193 points (a 1-point last cell), every 5th point copied at
    +1 (the same cell) and +128 (the next cell, which the reversed lists
    visit first), cell 2 all-invalid and in every list, cloud 1
    all-invalid; 778 rows (a 10-row last tile) at y_group 1 and 4; K = 24
    cells per tile, the cells in reversed order rotated by (frame + tile).
    Values bit-equal and indices equal to plain_h2o_topk; then with ids out
    of range in the lists (the kernel skips them), against the plain
    version on the same lists with those ids replaced by the empty cell."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    t0 = time.perf_counter()
    G, P1, P2, K = 3, 778, 8193, 24
    S = CC.S_CELL
    ties = 0
    for L in (1, 4):
        rng = np.random.default_rng(40 + L)
        F = G * L
        y = rng.normal(scale=0.05, size=(G, P2, 3))
        j = np.arange(0, P2 - S, 5)
        y[:, j + 1] = y[:, j]
        y[:, j + S] = y[:, j]
        yv = np.ones((G, P2), bool)
        yv[:, 2 * S : 3 * S] = False
        yv[1] = False
        t = lambda a: torch.from_numpy(np.asarray(a)).cuda()  # noqa: E731
        xs, y4, ctr = NN.prepare(t(rng.normal(scale=0.05, size=(F, P1, 3)).astype(np.float32)),
                                 t(y.astype(np.float32)), t(yv), L)
        T, C = -(-P1 // S), -(-P2 // S)
        rev = np.arange(C)[::-1]
        cidx = np.array([[np.roll(rev, f + k)[:K] for k in range(T)] for f in range(F)], np.int32)
        cidx[:, :, K // 2] = 2
        got = CC.launch_h2o_topk(xs, y4, ctr, t(cidx), L)
        want = CC.plain_h2o_topk(xs, y4, ctr, t(cidx), L)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"h2o_topk differs from plain on the tie scene at y_group {L}")
        # rows whose minimum a second point of the cloud also reaches
        yc = y4[..., :3].repeat_interleave(L, 0)
        found = got[0] < CC.BIG
        d2 = NN.sq_norm_rn(NN.centred_x(xs, ctr, L)[:, :, None, :] - yc[:, None, :, :])
        ties += int(((d2 == got[0][..., None]).sum(-1) > 1)[found].sum())
        del d2, yc
        oor = cidx.copy()
        oor[:, :, 0] = -1
        oor[:, 1::2, 1] = C + 3
        got = CC.launch_h2o_topk(xs, y4, ctr, t(oor), L)
        want = CC.plain_h2o_topk(xs, y4, ctr, t(np.where((oor >= 0) & (oor < C), oor, 2).astype(np.int32)), L)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"h2o_topk with ids out of range differs from plain on the same lists at y_group {L}")
    torch.cuda.synchronize()
    require(ties > 0, "the #10 tie scene ties no minimum")
    print(f"h2o_topk on the tie scene (reversed candidate lists, an empty cell in each, an all-invalid cloud, "
          f"P1 {P1}, P2 {P2}, K {K}, y_group 1 and 4): equal to plain ({ties} rows whose minimum two points "
          f"reach), and with ids out of range skipped; in {time.perf_counter() - t0:.1f} s", flush=True)


def check_o2h_topk_edges() -> None:
    """#12 on the tie scenes of tests/test_torch_o2h_cells.py: hand rows
    copied inside a 32-row segment, across segments and into the next tile;
    P1 778 (a 10-row last tile), P2 1000 (a 104-point last cell), and P1
    300 (44 rows), P2 700 (60 points); an all-invalid cell in every frame
    and an all-invalid frame; every tile listed in order, and 4 tiles
    reversed and rotated. Values, indices and numerators bit-equal to the
    test's numpy reference of the contract and to plain_o2h_topk; then with
    ids out of range in the lists (skipped), against the reference."""
    import importlib.util
    import itertools

    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC

    # the test file by its path: another installed package may be called `tests`
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_torch_o2h_cells.py")
    spec = importlib.util.spec_from_file_location("test_torch_o2h_cells", path)
    tm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tm)
    LISTS, SIZES, o2h_reference, o2h_scene = tm.LISTS, tm.SIZES, tm.o2h_reference, tm.o2h_scene
    t0 = time.perf_counter()
    ties = 0
    for lists, (P1, P2) in itertools.product(LISTS, SIZES):
        ops, _ = o2h_scene(lists, P1=P1, P2=P2)
        ops = [t.cuda() for t in ops]
        d, i, dot, n_ties = o2h_reference(*ops)
        ties += n_ties
        got = CC.launch_o2h_topk(*ops)
        for nm, a, b, c in zip(("o2h_d", "o2h_i", "o2h_dot"), got, (d, i, dot), CC.plain_o2h_topk(*ops)):
            require(torch.equal(a, torch.from_numpy(b).cuda()), f"o2h_topk {nm} differs from the reference "
                    f"on the tie scene ({lists} lists, P1 {P1}, P2 {P2})")
            require(torch.equal(a, c), f"o2h_topk {nm} differs from plain on the tie scene ({lists} lists, "
                    f"P1 {P1}, P2 {P2})")
        oor = ops[4].clone()
        oor[:, :, 0] = -1
        oor[:, 1::2, 1] = CC._cdiv(ops[0].shape[1], CC.S_CELL) + 3
        got = CC.launch_o2h_topk(*ops[:4], oor)
        for nm, a, b in zip(("o2h_d", "o2h_i", "o2h_dot"), got, o2h_reference(*ops[:4], oor)):
            require(torch.equal(a, torch.from_numpy(b).cuda()), f"o2h_topk {nm} with ids out of range differs "
                    f"from the reference ({lists} lists, P1 {P1}, P2 {P2})")
    torch.cuda.synchronize()
    require(ties > 100, "the #12 tie scenes tie too few minima")
    sizes = " and ".join(f"{a} x {b}" for a, b in SIZES)
    print(f"o2h_topk on the tie scenes (rows copied within a segment, across segments and tiles; P1 x P2 {sizes}; "
          f"an all-invalid cell and frame; lists {' and '.join(LISTS)}): equal to the reference and to plain "
          f"({ties} points whose minimum two rows reach), and with ids out of range skipped; in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


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
               NN.DVEC_KERNEL, CU.DVEC_KERNEL, HB.KERNEL, *CC.KERNELS, CL.CULL_KERNEL]
    t0 = time.perf_counter()
    _build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for k in kernels:
        print("\n".join(ln for ln in k.ptxas_log.splitlines() if "Used" in ln or "spill" in ln))
    sass = {}
    for k in (CS.KERNEL, CL.KERNEL, CL.CULL_KERNEL, CC.H2O_KERNEL, CU.KERNEL, CU.DVEC_KERNEL, NN.KERNEL,
              NN.DVEC_KERNEL, CC.O2H_KERNEL):  # the pair searches' hot loop
        st = sass[k.name] = sass_inner_loop(k)
        print(f"{k.name} SASS hot loop: {st['instructions']} instructions, {st['fast_path']} without the row "
              f"merge, {st['pairs']} pairs: {st['fast_path'] / max(st['pairs'], 1):.3f} per pair; "
              f"{st['opcodes']}", flush=True)
    for k in (CS.BWD_KERNEL, CC.O2H_BWD_KERNEL):  # the o2h scatter's loop (grad_y=False)
        st = sass[k.name] = scatter_sass(k)
        print(f"{k.name} SASS scatter loop: {st['instructions']} instructions ({st['fast_path']} outside the "
              f"blocks around the shared atomics), {st['pairs']} FMULs: {st['per_point']:.3f} per point "
              f"({st['fast_per_point']:.3f}); {st['opcodes']}", flush=True)

    def phase(label):
        print(f"--- {label} (at {time.perf_counter() - t_start:.1f} s)", flush=True)

    phase("serving kernels")
    kstats = check_kernels()
    phase("training kernels")
    kstats.update(check_training_kernels())
    phase("signed tie and edge cases")
    check_signed_edges()
    phase("o2h scatter contention scenes")
    check_scatter_contention()
    phase("fused_cull kernel")
    kstats.update(check_cull_loss_kernel())
    check_cull_loss_edges()
    phase("R kernels")
    kstats.update(check_r_kernels())
    check_cull_edges()
    check_nn_edges()
    phase("cluster kernels")
    kstats.update(check_cluster_kernels())
    check_topk_edges()
    check_o2h_topk_edges()
    for name in ("dist_loss", "dist_loss_cull", "h2o_topk", "h2o_cull", "h2o_cull_dvec", "h2o_nn",
                 "h2o_nn_dvec", "o2h_topk"):  # the redesigned searches
        st, o = sass[name], kstats[name]
        cells = name.startswith(("h2o_", "o2h_"))  # one search direction: 7 instructions per pair at least
        floor = issue_floor_ms(o["pairs"], 7 if cells else INSTR_PER_PAIR)
        extra = ""
        if "ms_2048" in o:
            extra = (f"; at tile 2048 {o['ms_2048']:.4f} ms (issue floor {o['issue_floor_ms_2048']:.4f} ms, kept share "
                     f"{o['kept_share_2048']:.4f}, mask {o['mask_ms_2048']:.4f} ms); at tile {CU.DEFAULT_TILE} kept share "
                     f"{o['kept_share']:.4f}, mask {o['mask_ms']:.4f} ms")
        elif "all_pairs_ms" in o:
            extra = f"; dist_loss on its operands {o['all_pairs_ms']:.4f} ms"
        elif "cell_share" in o:
            extra = (f"; {o['pairs']:.6g} valid pairs, {o['searched']:.6g} searched, cells with a valid point "
                     f"{o['cell_share']:.4f}")
        print(f"{name}: {ptxas_registers(o['kernel'])} registers, {st['fast_path'] / max(st['pairs'], 1):.3f} SASS "
              f"instructions per pair, {o['ms']:.4f} ms at {o['shape']} (bound {o['bound_ms']:.4f} ms, issue "
              f"floor {floor:.4f} ms){extra}", flush=True)
    for name in ("nn_signed_bwd", "o2h_topk_bwd"):  # the redesigned scatters
        st, o = sass[name], kstats[name]
        print(f"{name}: {ptxas_registers(o['kernel'])} registers, {st['per_point']:.3f} SASS instructions per "
              f"point in the scatter loop ({st['fast_per_point']:.3f} outside the atomics' blocks), {o['ms']:.4f} ms "
              f"at {o['shape']} (bound {o['bound_ms']:.4f} ms, library {o['library_ms']:.4f} ms); distinct rows "
              f"per 32 live points {o['rows_per_warp']:.4f}",
              flush=True)
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
    phase("training main path (fused_cull)")
    state, db, fc_counts, _ = train_main_path("fused_cull", state, db)
    phase("composed route")
    composed_counts = composed_route(state, db)
    del state, db
    torch.cuda.empty_cache()
    phase("entry point")
    entry_point()
    phase("entry point, fused_cull")
    entry_point("fused_cull")
    phase("gt_geom cache")
    gt_cache_path()
    phase("R training main path (cull route)")
    _, r_counts, _ = r_train_main_path()
    torch.cuda.empty_cache()
    phase("R training main path (all-pairs route)")
    _, r_ap_counts, _ = r_train_main_path("all-pairs")
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
    # fused G training path for #6/#8, its fused_cull route for #9, the
    # composed route for #7, the R training paths for #3 (cull) and #4
    # (all-pairs), the grad_y path for #5, the R cluster route for #10/#11,
    # the signed cluster entry point for #12/#13
    launches = {"h2o_nn": nn_counts["h2o_nn"], "h2o_cull": cull_counts["h2o_cull"],
                "nn_signed": train_counts["nn_signed"], "dist_loss": train_counts["dist_loss"],
                "dist_loss_cull": fc_counts["dist_loss_cull"],
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
