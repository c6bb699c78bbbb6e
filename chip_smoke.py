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
   plain versions, #4 equal to #3 on live frames; then the h2o cull mask
   kernel against its plain version at the serving and R shapes (8192
   points, tile 128): flags equal except within 1e-5 m of the threshold,
   timed with the plain version, region_stats and cull_mask whole;
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
   then the training options: G steps at model.compute_dtype bfloat16,
   with model.remat, and with both, and a bf16 R step (loss 1e-2 and
   gradients 1e-1 of their norm at bf16; remat in float32 as above), the
   model output reaching the loss float32;
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
   live points it meets there; then the G training options at full width
   on the fused route: bf16, remat and both beside float32 (two warm-up
   and 3 timed steps each from the same seed: step s, samples/s, peak
   GiB; #6 and #8 once per step), and a profiler trace of 2 float32 and 2
   bf16 steps (the five device operations with the most time, the
   device's busy share);
9. the entry point: launch/train_g.main on config/synthetic_smoke.yml on
   the card (two short epochs), on the fused and the fused_cull routes;
10. the gt_geom cache: train_g.main with train.data.cache_gt_geom (the
   signed forward runs in the precompute, not in the steps), then a fresh
   cache's cold misses computed in the loader's threads against the
   batched precompute; then train_g.main with runtime.profile_dir for 20
   steps: the Chrome trace of steps 11-20 must parse and hold device
   events of #6 and #8 by their symbol names (top device operations, busy
   share);
11. the R training main path, cull route: arch_refine, batch 64 x 160
   frames x 4 objects x 8192 points with target_h2o from TargetH2OCache,
   one warm-up step then 3 timed steps and the step's split; #2 and #3
   must launch once per step; the tile sweep on the operands the step
   hands #3; then the same on the all-pairs route at 2048 points (#1 and
   #4 once per step, no culled kernel), its split, and #1 and #4 timed on
   the operands the step hands them, with the share of cells that hold a
   valid point; then the all-pairs route at bf16 beside float32 (two
   warm-up and 3 timed steps each, #1 and #4 once per step, peak GiB);
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
   all-pairs kernel must have launched;
19. small sampler parity: parallel/train.make_g_sampler with each sampler
   (ddpm, ddim, plms, parallel) and models/extract_sample at 256 and 4096
   points (#1, #2), GPU against CPU with the same small weights, batch and
   noise: 1e-3; then core/diffusion's vb branches on a small G whose
   model_fn emits 2C channels, GPU against CPU: training_losses at KL and
   LEARNED_RANGE's vb term, calc_bpd_loop on 50 respaced steps (t > 0
   rtol 5e-4 / atol 1e-4, t = 0 and total_bpd 2e-2);
20. the samplers at full width: make_g_sampler at arch_mdm_l G, batch 64 x
   160 frames x 4 slots x 8192 points, 1000-step cosine schedule, DDPM,
   DDIM and PLMS once each (samples/s, finite), DDPM again with the trunk
   in bf16 (same weights and noise: wall s, the largest difference from
   the float32 chain's samples), the parallel sampler at
   batch 4 (window 64, tol 1e-2: sweeps, model evaluations, wall time)
   beside DDPM at batch 4; then the G -> R chain, extract_refined_sample on
   the same 64 segments (DDPM, same seed) and default R: #2 must launch, #1
   not (segments/s);
21. the sample launchers: launch/sample_g.main (16 .npy) and then
   launch/sample_r.main on those samples (16 save_dict.pkl) on the smoke
   config with --commit in a temporary directory; the weights, batches and
   outputs on the card, #1 launched; then eval/compute_score.main cr,
   psklj, fid and siv on those save_dicts on the card (CR: #1 twice per
   segment);
22. the scoring chain on real-format data: a fabricated cache_dict of 64
   segments x 160 frames over 4 objects of 8192 points with 768-d
   embeddings and box meshes (data/fabricate.py) through
   launch/common.build_dataset (host segments/s);
   launch/train_encoder.main at arch_encoder.yml widths, batch 64, 1
   warm-up and 3 timed steps (s/step, samples/s, peak GiB); compute_score
   cr, psklj and fid on an identity and a perturbed save_dict tree, siv on
   8 of the perturbed tree's segments at resolution 100, stride 20 (a
   depth cut: ~2 s of host hashing per containment test of the synthetic
   hand): wall s and segments/s per score, #1 twice per segment on the CR
   path, min_cdist against torch.cdist + min and #1's plain version on one
   segment; #1's and the yardstick's per-frame squared minima against a
   float64 witness on every segment's GT and refined hands (1e-7 and 1e-6
   m^2, no frame on the other side of 5 mm); CR's squared minima GPU vs
   CPU within 1e-7 m^2, the FID activations within 1e-4, the triangle hash
   built from the port's own source;
23. the process group (parallel/mesh.py): (a) one rank on NCCL, the
   full-width fused G step (#6, #8) and the all-pairs R step (#1, #4) at
   dropout 0 against the plain step on the same weights, batch, t and
   noise (loss rtol 1e-6, gradients 1e-6 of their norms), 3 timed steps of
   each between 3 plain ones before the group and 3 after, peak GiB, the
   gradient all-reduce alone and its share of the step (dist_cards.py runs
   these cells across cards); (b) two processes sharing cuda:0 on gloo,
   32 of the 64 rows each, the same two steps: losses within rtol 1e-5 of
   (a)'s and each gradient within 1e-5 of its norm, the ranks' parameters
   bitwise equal after 2 steps, each rank's launch counts; (c)
   launch/train_r.main on two ranks through torchrun's environment, both
   on cuda:0 over gloo, kernels built cold by both into one dir, a shared
   target-h2o cache dir: parameters bitwise equal, the cache complete,
   save/ on rank 0 alone. A rank that fails fails the run. In (b) each
   rank also runs launch/train_g.evaluate_g (the smoke config's G, DDPM,
   the extra loss through #6/#8) on its 8 of 16 global rows: its terms
   within rtol 1e-5 of one process's on the 16 (each global row its own
   noise);
24. the PointBERT tower (models/pointbert.py) at full width (8192 points,
   512 groups of 32, depth 12, width 384, 6 heads, random weights from
   seed 0) on the box toolkit's clouds, TF32 off: FPS indices equal on the
   card and the CPU for 2 clouds, the card's embeddings within 1e-4 of the
   CPU's max-abs; at batch 16 and 64 FPS, knn grouping, the tokenizer, the
   transformer and the whole call timed with CUDA events, the clouds per
   second and the peak GiB; FPS of one cloud (the 512-step loop's fixed
   cost) and its host enqueue time;
25. launch/compute_obj_assets.main on the card on 3 box meshes written to
   a temporary dir: 3 clouds equal to mesh_io.sample_surface's and 3
   finite 768-d embeddings, the first within 1e-4 of the CPU's;
26. the streaming xla route (core/geometry backend="xla", plain matmuls, no
   kernel) at 32 frames x 778 x 8192 with a ragged and an all-invalid
   cloud: point2point_signed with both normals and point2point_h2o
   (grad_y) under autograd, card against CPU (values rtol 1e-5 or the
   expansion's rounding, gradients 1e-4 of their norms), no kernel inside
   it, bitwise the same at a small tile budget; against #6 and #1 on the
   same operands (squared distances within 1e-6 m^2, equal-index shares);
   vertex_normals on a 10000 x 19602 mesh and MANO on each row's own side
   at R's shape (with normals), card against CPU; the full-width all-pairs R step at h2o_backend xla (1 warm-up and
   3 timed steps, peak GiB, no kernel launched) beside the all-pairs
   route's, and its two searches alone; launch/debug_refine at arch_refine
   widths on 16 segments x 8192 points (#2 launched), launch/debug_sample
   at arch_mdm_l (2 samples, 1000 DDPM steps), launch/viz_seg and
   launch/save_cache_dict on the smoke config, each writing its files (the
   HTML viewers; the PNGs only where matplotlib is installed, else the
   arrays each figure would draw are checked).
27. the JAX package's checkpoint format (runtime/ckpt.save_checkpoint and
   the `.ckpt` loaders): G at arch_mdm_l on the fused route (batch 64 x
   160 frames x 4 objects x 8192 points, fixed t and noise) and R at
   arch_refine on the all-pairs route (2048 points) each take one step,
   are saved as .pt and as .ckpt and loaded into fresh states: both
   bit-equal to the state saved (parameters, AdamW moments and step, lr,
   schedule count); after one more step of each on the same batch and
   seed, the .ckpt resume within 1e-6 of each tensor's norm of the .pt
   resume, plus 4 times the worst share of a norm by which two resumes
   that no .ckpt touched part (G's step is not bitwise reproducible on
   the card, R's is; attention's key bias, whose true gradient is 0,
   within AdamW's largest move twice);
   the .ckpt's size, write and
   read + convert + load seconds, the load's device and host peaks; then
   serving.TamfPipeline.load from the two .ckpt files and the two .pt
   files, a generate of 16 segments each on the cull route at 8192 points
   with 50 respaced steps from one seed: outputs within 1e-6 (#1, #2, #4,
   #6 and #8 counted in the kernels line).

The line before the last is the card's name and power limit
(nvidia-smi); before it, one JSON line with every kernel's numbers. The
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
        noise = [{"noise": torch.randn(2, 16, 99, generator=g), "step_noise": torch.randn(4, 2, 16, 99, generator=g)}]
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
            batch_recover_mano(mano, db["pose_repr"], db["shape"], db["hand_side"], normals=True)

    with torch.no_grad():
        verts, _, normals = batch_recover_mano(mano, db["pose_repr"], db["shape"], db["hand_side"], normals=True)
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


def mask_margins(cg, rr, yc, yv, tile: int, L: int, blocks):
    """The float64 margins (dmin + rr + 1e-3) - (d_t - rr) of the given
    blocks ([n, 3] (frame, region, tile) indices) from the exact distances
    of the same centred operands, 256 (frame, region) rows at a time."""
    import torch

    G, P2, _ = yc.shape
    R = rr.shape[1]
    T = -(-P2 // tile)
    out = torch.empty(blocks.shape[0], dtype=torch.float64, device=cg.device)
    for i in range(0, blocks.shape[0], 256):
        f, r, t = blocks[i : i + 256].unbind(1)
        g = f // L
        c = cg.reshape(-1, 3)[f * R + r].double()
        d = ((c[:, None] - yc[g].double()) ** 2).sum(-1).sqrt().masked_fill(~yv[g], float("inf"))
        d = torch.nn.functional.pad(d, (0, T * tile - P2), value=float("inf")).reshape(-1, T, tile).amin(-1)
        rb = rr[f, r].double()
        out[i : i + 256] = (d.amin(-1) + rb + 1e-3) - (d.gather(1, t[:, None])[:, 0] - rb)
    return out


def check_mask_kernel() -> dict[str, dict]:
    """The h2o cull mask kernel (csrc/h2o_cull_mask.cu) against its plain
    version (chamfer_cull.plain_mask) at the serving shape (10240 frames =
    64 clouds x 160, 778 rows, 8192 points) and the R training shape (40960
    = 256 x 160), tile 128, on kernel_inputs (a ragged cloud, an
    all-invalid cloud, every 7th frame x_valid=False): flags 0/1, 0 on dead
    frames, equal to the plain version's on every block whose float64
    margin lies more than 1e-5 m from the threshold (the blocks that differ
    counted); then timed: the kernel, the plain version, region_stats and
    cull_mask whole. Bound: 8 flops per (live centroid, valid point) pair,
    or cg, rr, y, the masks read and the flags written once."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU

    out = {}
    tile = CU.DEFAULT_TILE
    for label, G, seed in (("serving", 64, 11), ("R", TRAIN_CLOUDS, 12)):
        x, y, yv, xv, L = kernel_inputs(TRAIN_P, G=G, L=TRAIN_L, seed=seed)
        cg, rr, yc = CU.region_stats(x, y)
        flags = CU.launch_mask(cg, rr, yc, yv, xv, tile, L)
        torch.cuda.synchronize()
        want, plain_ms = cuda_timed(lambda: CU.plain_mask(cg, rr, yc, yv, xv, tile, L))
        live = xv & yv.any(1).repeat_interleave(L)
        require(bool(((flags == 0) | (flags == 1)).all()), f"mask kernel ({label}): a flag is not 0 or 1")
        require(bool((flags[~live] == 0).all()), f"mask kernel ({label}): a dead frame's block runs")
        differ = (flags != want).nonzero()
        margin = mask_margins(cg, rr, yc, yv, tile, L, differ)
        require(bool((margin.abs() <= 1e-5).all()),
                f"mask kernel ({label}): {int((margin.abs() > 1e-5).sum())} blocks differ from the plain version "
                f"farther than 1e-5 m from the threshold (margins {margin.tolist()[:8]})")
        F, R, T = flags.shape
        pairs = float((yv.sum(1).repeat_interleave(L) * live).sum()) * R
        n_bytes = (cg.numel() + rr.numel() + yc.numel() + flags.numel()) * 4 + yv.numel() + xv.numel()
        b, by = bound_ms(n_bytes, pairs)
        o = dict(
            kernel=CU.MASK_KERNEL, max_abs_err=int((flags != want).any()), differ=int(differ.shape[0]),
            shape=[F, x.shape[1], y.shape[1]], plain_ms=plain_ms, library_ms=None, bound_ms=b, bound_by=by,
            issue_floor_ms=issue_floor_ms(pairs, 7), pairs=pairs, kept_share=float(flags.sum()) / (float(live.sum()) * R * T),
            ms=cuda_time_ms(lambda: CU.launch_mask(cg, rr, yc, yv, xv, tile, L), reps=20),
            stats_ms=cuda_time_ms(lambda: CU.region_stats(x, y), reps=5),
            mask_ms=cuda_time_ms(lambda: CU.cull_mask(x, y, yv, tile, L, xv), reps=5),
        )
        print(f"h2o_cull_mask ({label}) F={F} P1={x.shape[1]} P2={y.shape[1]} y_group {L} tile {tile}: "
              f"{o['differ']} of {flags.numel()} flags differ from the plain version, each within 1e-5 m of the "
              f"threshold; ms={o['ms']:.4f} bound_ms={b:.4f} ({by}; {pairs:.6g} live pairs) issue floor "
              f"{o['issue_floor_ms']:.4f} ms; plain_ms={plain_ms:.3f}; region_stats {o['stats_ms']:.3f} ms, "
              f"cull_mask whole {o['mask_ms']:.3f} ms; kept share of live blocks {o['kept_share']:.4f}", flush=True)
        out[label] = o
        del x, y, yv, xv, cg, rr, yc, flags, want, live, differ
        torch.cuda.empty_cache()
    return {"h2o_cull_mask": out["R"]}


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
        verts, _, normals = R.batch_recover_mano(mano, db["sample_pose_repr"], db["shape"], db["hand_side"],
                                                 normals=True)
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
    tile) but for the sign at points whose nearest distance two verts share
    exactly; x2y equal on frames whose h2o certificate is clear, and gx
    within 1e-6 of its terms' magnitudes (scatter_mass_close) on those of
    them without such a tie."""
    import torch

    from oakink2_tamf_tpu_torch.core import geometry as TG
    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
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
    # the two routes scan the hand rows in different orders, so where two verts
    # lie at the same float32 distance from an object point (the kernels'
    # rounding) each may keep another of them, and its normal may sign y2x
    # the other way (ROADMAP's tie order); everywhere else y2x is bit-equal
    at = torch.nonzero(cy != ey)
    d2 = NN.sq_norm_rn(x[at[:, 0]] - y[at[:, 0], at[:, 1]][:, None])  # [k, 778]
    tied = (d2 == d2.min(dim=1, keepdim=True).values).sum(dim=1) >= 2
    require(torch.equal(cy.abs(), ey.abs()) and bool(tied.all()),
            f"signed cluster: y2x differs from the exact signed pair at {int((~tied).sum())} untied points")
    require(bool(ok.any()) and torch.equal(cx[ok], ex[ok]), "signed cluster: x2y differs on certified frames")
    # the o2h side's terms: cotangent a times sign over y2x (the exact pair's indices); a
    # frame with a tie sends its point's term to another vert, so it is left out of gx's
    ok = ok.index_fill(0, at[:, 0], False)
    o2h_i = CS.nn_signed(x, y, nrm, yv, 1)[3]
    sign = torch.where(ey != 0, torch.sign(ey), 0.0)
    mass = o2h_mass(x, y, o2h_i, a * sign / torch.clamp_min(ey.abs(), CS.DIST_EPS)) + eg.abs()
    require(scatter_mass_close(cg[ok], eg[ok], mass[ok]), f"signed cluster: gx differs on certified frames by "
            f"{(cg - eg)[ok].abs().max().item()}")
    print(f"signed cluster entry point F={f6} P2={TRAIN_P}: launches {counts}; y2x equal to the exact pair "
          f"but for {len(at)} signs at exact distance ties, x2y on the frames whose certificate is clear, "
          f"gx on the {int(ok.sum())} of {f6} of them without a tie (o2h overflow "
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


# ---------------------------------------------------------------------------
# The samplers and the G -> R sampling chain
# ---------------------------------------------------------------------------

SAMPLE_BS, SAMPLE_PARALLEL_BS = 64, 4  # sample_g's batch at full width; the parallel sampler's regime
SAMPLERS = ("ddpm", "ddim", "plms", "parallel")
# a depth cut for DDIM, PLMS and the parallel sampler ("" = all 1000 steps);
# DDPM always runs 1000
SAMPLE_RESPACING = ""


def _sampler_noise(sampler: str, T: int, shape, seed: int) -> dict:
    """The sampler's noise keywords, drawn on the CPU from `seed`."""
    import torch

    g = torch.Generator().manual_seed(seed)
    noise = {"noise": torch.randn(shape, generator=g)}
    if sampler == "ddpm":
        noise["step_noise"] = torch.randn((T,) + tuple(shape), generator=g)
    elif sampler == "parallel":
        noise["t_noise"] = torch.randn((T,) + tuple(shape), generator=g)
    return noise


def small_sampler_parity() -> None:
    """Each sampler through parallel/train.make_g_sampler, and
    extract_refined_sample on both h2o routes, on the card and on the CPU
    with the same small weights, batch and noise: 1e-3."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.extract_sample import extract_refined_sample
    from oakink2_tamf_tpu_torch.models.mdm_g import InteractionSegmentMDM, MDMConfig
    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig, SegmentRefineNet, stack_mano_models
    from oakink2_tamf_tpu_torch.parallel import train as PT

    small = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=2, dropout=0.0)
    T = 8
    torch.manual_seed(0)
    g_cpu, r_cpu = InteractionSegmentMDM(MDMConfig(**small)).eval(), SegmentRefineNet(RefineConfig(**small)).eval()
    g_gpu = InteractionSegmentMDM(MDMConfig(**small)).cuda().eval()
    r_gpu = SegmentRefineNet(RefineConfig(**small)).cuda().eval()
    g_gpu.load_state_dict(g_cpu.state_dict())
    r_gpu.load_state_dict(r_cpu.state_dict())
    sched = D.tamf_schedule(T)
    clips = {d: FrozenClipText(device=d) for d in ("cpu", "cuda")}
    for P in (256, 4096):
        segs = [SyntheticSegments(2, seq_len=16, max_nobj=2, n_obj_points=P, seed=5)[i] for i in range(2)]
        batch = {d: _train_batch(2, 16, 2, P, seed=5, clip=clips[d], device=torch.device(d)) for d in clips}
        for sampler in SAMPLERS if P == 256 else ("ddpm",):
            noise = _sampler_noise(sampler, T, (2, 16, 99), seed=6)
            fn = {d: PT.make_g_sampler(sched.to(d), sampler=sampler, parallel_window=4) for d in clips}
            a = fn["cuda"](g_gpu, batch["cuda"], None, noise=noise)
            b = fn["cpu"](g_cpu, batch["cpu"], None, noise=noise)
            require(a.is_cuda, f"{sampler}: the sample is not on the card")
            err = float((a.cpu() - b).abs().max())
            require(err < 1e-3, f"GPU vs CPU {sampler} sampler differs by {err}")
            print(f"small {sampler} sampler: GPU matches CPU, max abs err {err:.3g}", flush=True)
        mano = {d: stack_mano_models(M.get_mano_model(None, "right"), M.get_mano_model(None, "left"), d)
                for d in clips}
        noise = _sampler_noise("ddpm", T, (2, 16, 99), seed=7)
        out = {d: extract_refined_sample(g, sched.to(d), r, mano[d], segs, clips[d], max_nobj=2,
                                         n_obj_points=P, noise=noise)
               for d, g, r in (("cuda", g_gpu, r_gpu), ("cpu", g_cpu, r_cpu))}
        err = float(np.abs(out["cuda"] - out["cpu"]).max())
        require(err < 1e-3, f"GPU vs CPU extract_refined_sample at P={P} differs by {err}")
        print(f"small extract_refined_sample P={P}: GPU (kernels) matches CPU (plain), max abs err {err:.3g}",
              flush=True)


def sampler_main_path():
    """make_g_sampler at full width: arch_mdm_l G, batch 64 x 160 frames x 4
    slots x 8192 points, 1000-step cosine schedule, each sampler once (the
    parallel one at batch 4 beside DDPM at batch 4); then the G -> R chain,
    extract_refined_sample on the same 64 segments with DDPM, which must
    launch #2 and not #1. Returns (#2's launches in the chain, stats)."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.extract_sample import extract_refined_sample
    from oakink2_tamf_tpu_torch.models.mdm_g import InteractionSegmentMDM, MDMConfig
    from oakink2_tamf_tpu_torch.models.refine_r import SegmentRefineNet, RefineConfig, stack_mano_models
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.parallel import train as PT

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.manual_seed(0)
    g = InteractionSegmentMDM(MDMConfig.arch_mdm_l()).to(dev).eval().requires_grad_(False)
    torch.manual_seed(1)
    r = SegmentRefineNet(RefineConfig()).to(dev).eval().requires_grad_(False)
    clip = FrozenClipText(device=dev)
    L, nobj, P = 160, 4, 8192
    ds = SyntheticSegments(SAMPLE_BS, seq_len=L, max_nobj=nobj, n_obj_points=P, seed=13)
    segs = [ds[i] for i in range(SAMPLE_BS)]
    db = _train_batch(SAMPLE_BS, L, nobj, P, seed=13, clip=clip, device=dev)
    full = D.tamf_schedule(1000).to(dev)
    cut = D.tamf_schedule(1000, "cosine", SAMPLE_RESPACING).to(dev) if SAMPLE_RESPACING else full
    torch.cuda.synchronize()
    print(f"samplers: load + {SAMPLE_BS} segments {time.perf_counter() - t0:.2f} s; DDIM, PLMS and parallel at "
          f"{cut.num_timesteps} steps" + (f" (respaced '{SAMPLE_RESPACING}')" if SAMPLE_RESPACING else ""),
          flush=True)
    stats = {}
    samples = {}
    for sampler in ("ddpm", "ddim", "plms"):
        sched = full if sampler == "ddpm" else cut
        fn = PT.make_g_sampler(sched, sampler=sampler)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = fn(g, db, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finite = bool(torch.isfinite(x).all())
        require(tuple(x.shape) == (SAMPLE_BS, L, 99) and finite, f"{sampler}: shape {tuple(x.shape)}, finite {finite}")
        samples[sampler] = x
        stats[sampler] = {"wall_s": wall, "samples_per_s": SAMPLE_BS / wall, "steps": sched.num_timesteps}
        print(f"sampler {sampler}: batch {SAMPLE_BS} x {L} frames, {sched.num_timesteps} steps, {wall:.3f} s = "
              f"{SAMPLE_BS / wall:.3f} samples/s ({wall / sched.num_timesteps * 1e3:.3f} ms per step); "
              f"finite {finite}", flush=True)

    # DDPM with the trunk in bf16: the same weights and the same generator
    # seed, so the same x_T and step noise as the float32 chain above
    g_bf16 = InteractionSegmentMDM(dataclasses.replace(MDMConfig.arch_mdm_l(), compute_dtype="bfloat16"))
    g_bf16.load_state_dict(g.state_dict())
    g_bf16 = g_bf16.to(dev).eval().requires_grad_(False)
    fn = PT.make_g_sampler(full)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = fn(g_bf16, db, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(x).all())
    require(tuple(x.shape) == (SAMPLE_BS, L, 99) and finite, f"ddpm bf16: shape {tuple(x.shape)}, finite {finite}")
    diff = (x - samples["ddpm"]).abs().max().item()
    stats["ddpm_bf16"] = {"wall_s": wall, "samples_per_s": SAMPLE_BS / wall, "steps": full.num_timesteps,
                          "max_abs_diff_from_float32": diff}
    print(f"sampler ddpm, trunk in bf16: batch {SAMPLE_BS} x {L} frames, {full.num_timesteps} steps, {wall:.3f} s = "
          f"{SAMPLE_BS / wall:.3f} samples/s ({wall / full.num_timesteps * 1e3:.3f} ms per step) against "
          f"{stats['ddpm']['wall_s']:.3f} s in float32; finite {finite}; largest difference from the float32 "
          f"chain's samples (same noise) {diff:.4g}, their largest magnitude "
          f"{samples['ddpm'].abs().max().item():.4g}", flush=True)
    del g_bf16, x

    # the parallel sampler at batch 4: its sweeps and latency beside DDPM's
    small = {k: v[:SAMPLE_PARALLEL_BS] for k, v in db.items()}
    with torch.inference_mode():
        fn_ddpm = PT.make_g_sampler(full)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x4 = fn_ddpm(g, small, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        ddpm4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        xp, info = D.p_sample_loop_parallel(
            PT.g_model_fn(g, PT.g_cond_from_batch(small)), cut, tuple(x4.shape), device=dev,
            generator=torch.Generator(device=dev).manual_seed(0), window=64, tol=1e-2, return_info=True)
        torch.cuda.synchronize()
        par4 = time.perf_counter() - t0
    finite = bool(torch.isfinite(xp).all())
    require(finite and tuple(xp.shape) == (SAMPLE_PARALLEL_BS, L, 99), "parallel: non-finite or misshapen sample")
    require(info["n_sweeps"] <= cut.num_timesteps, f"parallel: {info}")
    stats["parallel"] = {"wall_s": par4, "ddpm_wall_s": ddpm4, "steps": cut.num_timesteps, **info}
    print(f"sampler parallel: batch {SAMPLE_PARALLEL_BS}, window 64, tol 1e-2, {cut.num_timesteps} steps: "
          f"{info['n_sweeps']} sweeps, {info['n_model_evals']} model evals (one call of "
          f"{min(64, cut.num_timesteps) * SAMPLE_PARALLEL_BS} rows per sweep), {par4:.3f} s; DDPM at batch "
          f"{SAMPLE_PARALLEL_BS}, 1000 steps: "
          f"{ddpm4:.3f} s ({ddpm4 / par4:.2f}x); finite {finite}", flush=True)
    del samples["ddim"], samples["plms"]
    torch.cuda.empty_cache()

    # the G -> R chain on the same 64 segments, DDPM with the same generator seed
    mano = stack_mano_models(M.get_mano_model(None, "right"), M.get_mano_model(None, "left"), dev)
    NN.KERNEL.launches = 0
    CU.KERNEL.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = extract_refined_sample(g, full, r, mano, segs, clip, torch.Generator(device=dev).manual_seed(0),
                                     max_nobj=nobj, n_obj_points=P)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"h2o_nn": NN.KERNEL.launches, "h2o_cull": CU.KERNEL.launches}
    require(counts["h2o_cull"] > 0 and counts["h2o_nn"] == 0, f"G->R chain at {P} points: launches {counts}")
    require(refined.shape == (SAMPLE_BS, L, 99) and np.isfinite(refined).all(), "G->R chain: bad refined output")
    stats["chain"] = {"wall_s": wall, "segments_per_s": SAMPLE_BS / wall, **counts}
    print(f"G->R chain (extract_refined_sample, DDPM 1000 steps + R): {SAMPLE_BS} segments x {L} frames x {nobj} "
          f"slots x {P} points in {wall:.3f} s = {SAMPLE_BS / wall:.3f} segments/s ({stats['ddpm']['wall_s']:.3f} s "
          f"of it the DDPM chain alone above); launches {counts}", flush=True)
    del samples, g, r
    torch.cuda.empty_cache()
    return counts["h2o_cull"], stats


def sample_entry_points() -> tuple[int, int]:
    """launch/sample_g.main then launch/sample_r.main on the synthetic smoke
    config on the card, with --commit, in a temporary directory: 16 .npy
    samples, then 16 save_dict.pkl refined from them (128-point clouds:
    #1). The G and R weights, the batches and the outputs must sit on the
    card. Then eval/compute_score.main cr, psklj, fid and siv (one frame per
    segment, resolution 32) on those save_dicts, on the card: CR must launch
    #1 twice per segment. Returns #1's launches in sample_r and in the
    compute_score chain."""
    import pickle
    import tempfile

    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.eval import compute_score
    from oakink2_tamf_tpu_torch.launch import sample_g, sample_r
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.parallel import train as PT

    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config/synthetic_smoke.yml")
    seen = []
    make_g_sampler, refine_forward = PT.make_g_sampler, sample_r.refine_forward

    def recording_sampler(*a, **kw):
        fn = make_g_sampler(*a, **kw)

        def sample_fn(model, batch, generator, noise=None):
            out = fn(model, batch, generator, noise)
            seen.append(("G", next(model.parameters()).device.type, batch["pose_repr"].device.type, out.device.type))
            return out

        return sample_fn

    def recording_forward(net, mano_stack, batch, **kw):
        out = refine_forward(net, mano_stack, batch, **kw)
        seen.append(("R", next(net.parameters()).device.type, batch["sample_pose_repr"].device.type,
                     out["refine_pose_repr"].device.type))
        return out

    cwd = os.getcwd()
    NN.KERNEL.launches = 0
    CU.KERNEL.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        PT.make_g_sampler, sample_r.refine_forward = recording_sampler, recording_forward
        try:
            t0 = time.perf_counter()
            out_dir = sample_g.main(["--cfg", cfg, "--exp_id", "chip_smoke_sg", "--sample.batch_size", "8",
                                     "--commit"])
            t_g = time.perf_counter() - t0
            files = sorted(os.listdir(out_dir))
            arrays = [np.load(os.path.join(out_dir, f)) for f in files]
            t0 = time.perf_counter()
            out_root = sample_r.main(["--cfg", cfg, "--exp_id", "chip_smoke_sr", "--sample.batch_size", "8",
                                      "--test.data.pose_repr_sample_dir_list", out_dir, "--commit"])
            t_r = time.perf_counter() - t0
            pkls = [os.path.join(d, f) for d, _, fs in os.walk(out_root) for f in fs if f == "save_dict.pkl"]
            dicts = []
            for p in pkls:
                with open(p, "rb") as f:
                    dicts.append(pickle.load(f))
            counts = {"h2o_nn": NN.KERNEL.launches, "h2o_cull": CU.KERNEL.launches}
            NN.KERNEL.launches = 0
            scores = {}
            for which in ("cr", "psklj", "fid", "siv"):
                t0 = time.perf_counter()
                n0 = NN.KERNEL.launches
                scores[which] = compute_score.main([which, "--cfg", cfg, "--score.sample_dir", out_root,
                                                    "--score.frame_stride", "32", "--score.sdf_resolution", "32"])
                scores[which]["wall_s"] = time.perf_counter() - t0
                scores[which]["h2o_nn_launches"] = NN.KERNEL.launches - n0
            score_nn = NN.KERNEL.launches
        finally:
            PT.make_g_sampler, sample_r.refine_forward = make_g_sampler, refine_forward
            os.chdir(cwd)
    require(files == [f"{i:06d}.npy" for i in range(16)], f"sample_g wrote {files}")
    require(all(a.shape == (32, 99) and np.isfinite(a).all() for a in arrays), "sample_g: bad samples")
    require(len(dicts) == 16, f"sample_r wrote {len(dicts)} save_dict.pkl")
    for d in dicts:
        require(d["verts"].shape == (32, 778, 3) and d["joints"].shape == (32, 21, 3)
                and d["refine_pose_repr"].shape == (32, 99) and d["faces"].ndim == 2
                and all(np.isfinite(d[k]).all() for k in ("verts", "joints", "refine_pose_repr")),
                "sample_r: bad save_dict")
    require(seen and all(s[1:] == ("cuda", "cuda", "cuda") for s in seen), f"launchers off the card: {seen}")
    require(counts["h2o_nn"] > 0, f"sample_r: #1 never launched ({counts})")
    print(f"sample_g.main (synthetic_smoke.yml, cuda, --commit): {len(files)} samples in {t_g:.2f} s; "
          f"sample_r.main on them: {len(dicts)} save_dict.pkl in {t_r:.2f} s; G and R calls on the card "
          f"{len(seen)}; launches {counts}", flush=True)
    require(all(np.isfinite(v) for r in scores.values() for v in r.values()), f"compute_score: {scores}")
    require(scores["cr"]["h2o_nn_launches"] == 2 * len(dicts) and scores["siv"]["n_frames"] > 0,
            f"compute_score on sample_r's output: {scores}")
    print(f"compute_score.main on sample_r's {len(dicts)} save_dicts (cuda): " + json.dumps(scores), flush=True)
    torch.cuda.synchronize()
    return counts["h2o_nn"], score_nn


# the scoring stage: real-format data at full width (fabricated), the FID
# encoder's training and compute_score; SIV on the first SCORE_SIV_SEGMENTS
# segments only (a depth cut: each containment test of the synthetic hand
# spends ~2 s hashing its large triangles on the host)
SCORE_SEGMENTS, SCORE_L, SCORE_OBJ, SCORE_P, SCORE_EMB = 64, 160, 4, 8192, 768
SCORE_OBJS_PER_SEGMENT, SCORE_SIV_SEGMENTS, SCORE_SIGMA, SCORE_ENC_BS = 2, 8, 0.05, 64


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def scoring_path(dev: str = "cuda"):
    """The scoring chain on real-format data: a fabricated cache_dict pickle
    (SCORE_SEGMENTS segments x SCORE_L frames over SCORE_OBJ objects of
    SCORE_P points, SCORE_EMB-d embeddings, each segment holding
    SCORE_OBJS_PER_SEGMENT objects) and the box toolkit's meshes, through
    launch/common.build_dataset (dataset + collate segments/s on the host);
    launch/train_encoder.main at arch_encoder.yml widths, batch SCORE_ENC_BS
    (64), two epochs of 2 steps over the identity and perturbed views: 1
    warm-up and 3 timed steps (s/step, samples/s, peak GiB), its checkpoint
    written; compute_score cr, psklj and fid on an identity and a perturbed
    save_dict tree, siv on SCORE_SIV_SEGMENTS segments of the perturbed one
    (resolution 100, stride 20): wall s and segments/s per score, #1's
    launches on the CR path (2 per segment) and min_cdist's time per segment
    beside torch.cdist + min on the same operands. Checks: #1's per-frame
    squared minima equal its plain version's on the card within 1e-7 m^2 on
    the timed segment; on every segment's GT and refined hands they equal a
    float64 witness within 1e-7 m^2 (the library yardstick's within 1e-6) and
    no frame changes side of CR's 5 mm; CR's squared minima on the card equal
    the CPU plain route's within 1e-7 m^2 on a subset, the FID activations
    within 1e-4, the scores finite, the triangle
    hash built from the port's own source. Returns (#1's CR launches, stats)."""
    import argparse
    import tempfile

    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch import native
    from oakink2_tamf_tpu_torch.core import geometry as G
    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.data import fabricate as F
    from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
    from oakink2_tamf_tpu_torch.eval import compute_score as CSC
    from oakink2_tamf_tpu_torch.eval import metrics as ME
    from oakink2_tamf_tpu_torch.launch import common, param, train_encoder
    from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.parallel import train as PT
    from oakink2_tamf_tpu_torch.runtime.config import ConfigRegistry
    from oakink2_tamf_tpu_torch.runtime.ckpt import load_model_weights

    repo = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    stats: dict = {"card": card}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            # 1. the data, through build_dataset's real branch
            t0 = time.perf_counter()
            paths = F.write_dataset(tmp, SCORE_SEGMENTS, seq_len=SCORE_L, n_obj=SCORE_OBJ, n_points=SCORE_P,
                                    emb_dim=SCORE_EMB, objs_per_seg=SCORE_OBJS_PER_SEGMENT, seed=0)
            t_write = time.perf_counter() - t0
            data_argv = ["--data.synthetic", "false", "--data.enable_obj_model", "true",
                         "--data.max_nobj", str(SCORE_OBJ), "--data.n_obj_points", str(SCORE_P),
                         "--data.obj_embedding_prefix", paths["obj_embedding_prefix"],
                         "--data.obj_pointcloud_prefix", paths["obj_pointcloud_prefix"],
                         "--train.cache_dict_filepath", paths["cache_dict"],
                         "--test.cache_dict_filepath", paths["cache_dict"]]
            reg = ConfigRegistry("chip_smoke_score")
            for fn in (param.reg_base_param, param.reg_mano_param, param.reg_model_param, CSC.reg_score_param):
                fn(reg)
            parser = argparse.ArgumentParser()
            reg.hook(parser)
            reg.parse(parser, ["--cfg", os.path.join(repo, "config/arch_encoder.yml"), *data_argv,
                               "--score.sdf_resolution", "100", "--score.frame_stride", "20"])
            toolkit = F.BoxToolkit()
            t0 = time.perf_counter()
            dataset = common.build_dataset(reg, "test", toolkit=toolkit)
            samples = [dataset[i] for i in range(len(dataset))]
            collate = SegmentCollate(max_nobj=SCORE_OBJ, n_obj_points=SCORE_P)
            batches = [collate(samples[i : i + 16]) for i in range(0, len(samples), 16)]
            t_data = time.perf_counter() - t0
            require(len(dataset) == SCORE_SEGMENTS and all(len(s["obj_verts"]) == s["obj_num"] for s in samples),
                    "build_dataset: segments or meshes missing")
            require(batches[0]["obj_points"].shape == (min(16, SCORE_SEGMENTS), SCORE_OBJ, SCORE_P, 3),
                    "collate: bad obj_points")
            stats["data"] = {"write_s": t_write, "load_collate_s": t_data,
                             "segments_per_s": SCORE_SEGMENTS / t_data}
            print(f"real-format data: {SCORE_SEGMENTS} segments x {SCORE_L} frames, {SCORE_OBJ} objects x "
                  f"{SCORE_P} points, {SCORE_EMB}-d embeddings written in {t_write:.2f} s; build_dataset + every "
                  f"sample + collate (batches of 16) on the host {t_data:.3f} s = {SCORE_SEGMENTS / t_data:.2f} "
                  f"segments/s ({card})", flush=True)

            # 2. the FID encoder's training, its checkpoint kept for FID
            step_s, seen = [], []
            make_step = PT.make_encoder_train_step

            def timed_step_factory():
                fn = make_step()

                def step(state, batch):
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = fn(state, batch)
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    step_s.append(time.perf_counter() - t)
                    seen.append((next(state.model.parameters()).device.type, batch["pose_repr"].device.type,
                                 int(batch["pose_repr"].shape[0])))
                    return out

                return step

            if dev == "cuda":
                torch.cuda.reset_peak_memory_stats()
            PT.make_encoder_train_step = timed_step_factory
            try:
                t0 = time.perf_counter()
                state = train_encoder.main(["--cfg", os.path.join(repo, "config/arch_encoder.yml"), *data_argv,
                                            "--runtime.device", dev, "--train.batch_size", str(SCORE_ENC_BS),
                                            "--train.num_epoch", "2", "--train.val_freq", "0",
                                            "--exp_id", "chip_smoke_enc", "--commit"])
                t_main = time.perf_counter() - t0
            finally:
                PT.make_encoder_train_step = make_step
            peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else float("nan")
            require(state.step == 4 and len(step_s) == 4, f"train_encoder.main took {state.step} steps, expected 4")
            require(all(v == (dev, dev, SCORE_ENC_BS) for v in seen), f"encoder steps off the card: {seen}")
            require(all(torch.isfinite(p).all() for p in state.model.parameters())
                    and not state.model.classification_token.any(), "train_encoder: non-finite or moved token")
            timed = float(np.mean(step_s[1:]))
            stats["encoder_train"] = {"s_per_step": timed, "samples_per_s": SCORE_ENC_BS / timed,
                                      "warmup_s": step_s[0], "peak_gib": peak, "main_s": t_main}
            print(f"train_encoder.main (arch_encoder.yml, batch {SCORE_ENC_BS}, {dev}): warm-up step {step_s[0]:.4f} s, "
                  f"3 timed steps {timed:.4f} s/step = {SCORE_ENC_BS / timed:.1f} samples/s, peak {peak:.3f} GiB; "
                  f"main {t_main:.2f} s ({card})", flush=True)
            ckpt = os.path.join(tmp, "common/train_encoder/chip_smoke_enc/save/model_0001.pt")
            require(os.path.isfile(ckpt), "train_encoder.main wrote no checkpoint")
            reg.values["score.encoder_filepath"] = ckpt

            # 3. the save_dict trees and the scores
            mano_rh, mano_lh = M.get_mano_model(None, "right"), M.get_mano_model(None, "left")
            mano = stack_mano_models(mano_rh, mano_lh, dev)
            faces = {0: M.closed_faces(mano_rh), 1: M.closed_faces(mano_lh)}
            trees = {k: CSC.load_save_dicts(F.write_save_dicts(os.path.join(tmp, k), samples, mano, faces,
                                                               sigma=sig, seed=1))
                     for k, sig in (("identity", 0.0), ("perturbed", SCORE_SIGMA))}
            scores: dict = {}
            cr_launches = 0
            for tree, sds in trees.items():
                for which in ("cr", "psklj", "fid", "siv"):
                    if which == "siv" and tree == "identity":
                        continue
                    sub = sds if which != "siv" else {k: sds[k] for k in sorted(sds)[:SCORE_SIV_SEGMENTS]}
                    NN.KERNEL.launches = 0
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = CSC.RUNNERS[which](reg, dataset, sub, mano)
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    n1 = NN.KERNEL.launches
                    if which == "cr":
                        require(dev != "cuda" or n1 == 2 * len(sub), f"CR on {tree}: #1 launched {n1} times "
                                f"for {len(sub)} segments")
                        if tree == "perturbed":
                            cr_launches = n1
                    require(all(np.isfinite(v) for v in res.values()), f"{which} on {tree}: {res}")
                    scores[f"{which}/{tree}"] = {**res, "wall_s": wall, "segments": len(sub),
                                                 "segments_per_s": len(sub) / wall, "h2o_nn_launches": n1}
                    print(f"compute_score {which} ({tree} tree, {len(sub)} segments): {res}; {wall:.3f} s = "
                          f"{len(sub) / wall:.2f} segments/s; #1 launches {n1} ({card})", flush=True)
            idn = scores["cr/identity"]
            require(idn["gt_contact_ratio"] == idn["refined_contact_ratio"], f"CR identity: {idn}")
            require(abs(scores["fid/identity"]["fid"]) < 1e-3, f"FID identity: {scores['fid/identity']}")
            require(scores["siv/perturbed"]["n_frames"] > 0, "SIV scored no frame")
            stats["scores"] = scores
            stats["cr_h2o_nn_launches"] = cr_launches

            # 4. min_cdist against torch.cdist + min on one segment's operands;
            # #1's per-frame d^2 held against its plain version's on the card
            s = samples[int(np.argmax([x["len"] for x in samples]))]
            n = int(s["len"])
            merged = ME.transf_merge_obj_pointcloud(s["obj_pointcloud"], s["obj_traj"][:, :n], dev)
            hv = torch.as_tensor(CSC.gt_hand_geometry(mano, s)[0][:n], device=dev)
            if dev == "cuda":
                ms = cuda_time_ms(lambda: G.min_cdist(hv, merged), reps=10)
                lib_ms = cuda_time_ms(lambda: library_min(hv, merged).amin(-1), reps=3)
                plain_d2, plain_ms = cuda_timed(lambda: NN.plain(*NN.prepare(hv, merged, None, 1), 1)[0].amin(1))
                plain_err = float((NN.h2o_nn(hv, merged, None, 1)[0].amin(1) - plain_d2).abs().max())
                require(plain_err <= 1e-7, f"CR min_cdist: #1's per-frame d^2 differs from its plain version's by "
                        f"{plain_err} m^2 on the timed segment")
                lib_err = float((library_min(hv, merged).amin(-1) - G.min_cdist(hv, merged)).abs().max())
            else:
                ms = lib_ms = plain_ms = plain_err = lib_err = float("nan")
            n_bytes = (hv.numel() + merged.numel() + n) * 4
            bound, by = bound_ms(n_bytes, float(n * hv.shape[1] * merged.shape[1]))
            stats["min_cdist"] = {"frames": n, "rows": int(hv.shape[1]), "points": int(merged.shape[1]), "ms": ms,
                                  "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                                  "plain_d2_max_abs_err": plain_err, "library_max_abs_diff": lib_err}
            print(f"CR min_cdist on one segment ({n} frames x 778 rows x {merged.shape[1]} points): #1 {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms (per-frame d^2 max |diff| {plain_err:.3g} m^2), torch.cdist + min "
                  f"{lib_ms:.4f} ms (max |diff| {lib_err:.3g} m), bound {bound:.4f} ms ({by}) ({card})", flush=True)

            # 5. every CR segment's GT and refined hands against a float64
            # witness (torch.cdist on the operands in float64): #1's per-frame
            # d^2, the library yardstick's, and CR's under-5-mm flags
            sd_pert = trees["perturbed"]
            wit = {"kernel": 0.0, "library": 0.0, "flag_flips": 0, "near_threshold": 0, "frames": 0}
            with torch.inference_mode():
                for s in samples:
                    n = int(s["len"])
                    merged = ME.transf_merge_obj_pointcloud(s["obj_pointcloud"], s["obj_traj"][:, :n], dev)
                    for hv_np in (CSC.gt_hand_geometry(mano, s)[0][:n], sd_pert[tuple(s["info"])]["verts"][:n]):
                        hv = torch.as_tensor(np.asarray(hv_np), dtype=torch.float32, device=dev)
                        want = library_min(hv.double(), merged.double()).amin(-1) ** 2
                        got = NN.h2o_nn(hv, merged, None, 1)[0].amin(1).double()
                        lib = library_min(hv, merged).amin(-1).double() ** 2
                        wit["kernel"] = max(wit["kernel"], float((got - want).abs().max()))
                        wit["library"] = max(wit["library"], float((lib - want).abs().max()))
                        d_got = ME.contact_min_dists(hv, merged).astype(np.float64)
                        d_want = want.sqrt().cpu().numpy()
                        wit["flag_flips"] += int(((d_got < 0.005) != (d_want < 0.005)).sum())
                        wit["near_threshold"] += int((np.abs(d_want - 0.005) <= 1e-5).sum())
                        wit["frames"] += n
            require(wit["kernel"] <= 1e-7, f"CR: #1's per-frame d^2 differs from the float64 witness by "
                    f"{wit['kernel']} m^2")
            require(wit["library"] <= 1e-6, f"CR: torch.cdist + min's per-frame d^2 differs from the float64 "
                    f"witness by {wit['library']} m^2")
            require(wit["flag_flips"] == 0, f"CR: {wit['flag_flips']} frames change side of 5 mm against the witness")
            stats["cr_witness"] = wit
            print(f"CR against a float64 witness on every segment ({wit['frames']} frames, GT and refined): #1's "
                  f"per-frame d^2 max |diff| {wit['kernel']:.3g} m^2 (<= 1e-7), torch.cdist + min's "
                  f"{wit['library']:.3g} m^2 (<= 1e-6); {wit['flag_flips']} frames on the other side of 5 mm; "
                  f"{wit['near_threshold']} within 1e-5 m of it ({card})", flush=True)

            # 6. the GPU against the CPU: CR's squared minima, FID's activations
            mano_cpu = stack_mano_models(mano_rh, mano_lh, "cpu")
            worst = 0.0
            for s in samples[:2]:
                n = min(int(s["len"]), 8)
                for hv_np in (CSC.gt_hand_geometry(mano_cpu, s)[0][:n], sd_pert[tuple(s["info"])]["verts"][:n]):
                    got = ME.contact_min_dists(hv_np, ME.transf_merge_obj_pointcloud(
                        s["obj_pointcloud"], s["obj_traj"][:, :n], dev)).astype(np.float64)
                    want = ME.contact_min_dists(hv_np, ME.transf_merge_obj_pointcloud(
                        s["obj_pointcloud"], s["obj_traj"][:, :n])).astype(np.float64)
                    worst = max(worst, float(np.abs(got ** 2 - want ** 2).max()))
            require(worst <= 1e-7, f"CR squared minima: GPU vs CPU differ by {worst}")
            model = train_encoder.build_encoder(reg)
            load_model_weights(model, ckpt)
            pairs = list(CSC.iter_eval_pairs(dataset, {k: sd_pert[k] for k in sorted(sd_pert)[:16]}))
            acts = {d: CSC.fid_activations(model.to(d).eval(), collate, pairs, torch.device(d))
                    for d in (dev, "cpu")}
            act_err = max(float(np.abs(a - b).max()) for a, b in zip(acts[dev], acts["cpu"]))
            require(act_err <= 1e-4, f"FID activations: GPU vs CPU differ by {act_err}")
            lib_path = native.get_lib()._name
            require(os.path.realpath(lib_path) == os.path.realpath(native.library_path())
                    and os.path.realpath(lib_path).startswith(os.path.realpath(native.BUILD_DIR)),
                    f"the inside-mesh library {lib_path} is not the port's own build")
            stats["checks"] = {"cr_d2_max_abs_err": worst, "fid_activation_max_abs_err": act_err,
                               "native_library": os.path.relpath(lib_path, repo)}
            print(f"scoring checks: CR squared minima GPU vs CPU max |diff| {worst:.3g} m^2 (<= 1e-7); FID "
                  f"activations GPU vs CPU {act_err:.3g} (<= 1e-4); triangle hash {os.path.relpath(lib_path, repo)}",
                  flush=True)
        finally:
            os.chdir(cwd)
    return cr_launches, stats


# ---------------------------------------------------------------------------
# Training options: the bf16 trunk, remat, the vb branches, the profiler
# ---------------------------------------------------------------------------

OPTION_GRAD_RTOL = 1e-1  # norm-wise, a bf16 step's clipped gradients GPU vs CPU (bf16 rounding, 1-5%)
OPTION_LOSS_RTOL = 1e-2  # a bf16 step's loss GPU vs CPU


def _grad_gap(a: dict, b: dict) -> float:
    """max over parameters of ||a - b|| / (||b|| + 1e-6)."""
    return max((a[k] - g).norm().item() / (g.norm().item() + 1e-6) for k, g in b.items())


def small_option_parity() -> None:
    """Small G steps (bf16 on the fused route; remat at dropout 0 in float32
    and in bf16) and a small bf16 R step (all-pairs route), on the GPU
    (kernels) and on the CPU (plain versions): the same weights, batch, t
    and noise. The model output that reaches the extra loss must be
    float32 on both. float32 with remat is held as the float32 steps are
    (loss 1e-4, gradients 2e-3 of their norm); a bf16 step's loss within
    OPTION_LOSS_RTOL and its gradients within OPTION_GRAD_RTOL of their
    norm: the card's and the CPU's bf16 matmuls round their outputs alike
    but sum in other orders, and a one-ulp difference of a bf16 value is
    4e-3 of it."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig

    small = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, dropout=0.0)
    rng = np.random.default_rng(6)
    noise = torch.from_numpy(rng.normal(size=(4, 16, 99)).astype(np.float32))
    t = torch.tensor([0, 10, 500, 999])
    g_cases = (("bf16", dict(compute_dtype="bfloat16")), ("remat", dict(remat=True)),
               ("bf16 + remat", dict(compute_dtype="bfloat16", remat=True)))
    for label, opts in g_cases:
        res = {}
        for dev in ("cuda", "cpu"):
            clip = FrozenClipText(device=dev)
            db = _train_batch(4, 16, 2, 512, seed=5, clip=clip, device=dev)
            db.update(t=t.to(dev), t_weights=torch.ones(4, device=dev))
            state, step, _ = _g_training(torch.device(dev), MDMConfig(**small, **opts), "auto")
            outs = []
            state.model.register_forward_hook(lambda m, a, out: outs.append(out.dtype))
            m = step(state, db, noise=noise.to(dev))
            require(outs == [torch.float32], f"small G step ({label}, {dev}): model output dtypes {outs}")
            res[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in state.model.named_parameters()})
        la, lb = res["cuda"][0], res["cpu"][0]
        bf16 = "compute_dtype" in opts
        rtol, gtol = (OPTION_LOSS_RTOL, OPTION_GRAD_RTOL) if bf16 else (1e-4, 2e-3)
        gap = _grad_gap(res["cuda"][1], res["cpu"][1])
        require(abs(la - lb) <= rtol * abs(lb), f"small G step ({label}): GPU loss {la} vs CPU {lb}")
        require(gap <= gtol, f"small G step ({label}): gradients differ by {gap} of their norm")
        print(f"small G train step ({label}, fused route): GPU (kernels) vs CPU (plain) loss {la:.6f} / {lb:.6f}, "
              f"worst relative grad diff {gap:.2e} (bound {gtol:g}); model output float32", flush=True)
    res = {}
    for dev in ("cuda", "cpu"):
        cfg = RefineConfig(**small, compute_dtype="bfloat16")
        state, step, mano, _ = _r_training(torch.device(dev), cfg, "auto")
        db, _ = _r_batch(4, 16, 2, 512, 5, mano, torch.device(dev), cache=False)
        outs = []
        state.model.register_forward_hook(lambda m, a, out: outs.append(out.dtype))
        m = step(state, db)
        require(outs == [torch.float32], f"small R step (bf16, {dev}): net output dtypes {outs}")
        res[dev] = (float(m["loss"]), {k: p.grad.cpu() for k, p in state.model.named_parameters()})
    la, lb = res["cuda"][0], res["cpu"][0]
    gap = _grad_gap(res["cuda"][1], res["cpu"][1])
    require(abs(la - lb) <= OPTION_LOSS_RTOL * abs(lb), f"small R step (bf16): GPU loss {la} vs CPU {lb}")
    require(gap <= OPTION_GRAD_RTOL, f"small R step (bf16): gradients differ by {gap} of their norm")
    print(f"small R train step (bf16, all-pairs route): GPU (kernels) vs CPU (plain) loss {la:.6f} / {lb:.6f}, "
          f"worst relative grad diff {gap:.2e} (bound {OPTION_GRAD_RTOL:g}); net output float32", flush=True)


def _timed_steps(step_call, n: int = 3):
    """(mean step s, per-step s, losses, peak GiB) of n steps after the
    counts were set to 0 by the caller; peak over the n steps."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        m = step_call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    require(all(v == v and abs(v) < float("inf") for v in losses), f"non-finite training loss {losses}")
    return sum(times) / n, times, losses, torch.cuda.max_memory_allocated() / 2**30


def g_option_main_path(db) -> dict:
    """G training at full width (arch_mdm_l, dropout 0.1, batch 64 x 160
    frames x 4 objects x 8192 points, fused route) with model.compute_dtype
    bfloat16, with model.remat, and with both, beside float32 in the same
    process: each from the same seed, two warm-up steps and 3 timed steps,
    #6 and #8 once per step; then, for float32 and bf16, a profiler trace
    of 2 more steps (trace_summary). -> {variant: (step s, peak GiB)}."""
    import torch

    import tempfile

    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS
    from oakink2_tamf_tpu_torch.runtime import profiler as P

    dev = torch.device("cuda")
    kernels = {"nn_signed": CS.KERNEL, "dist_loss": CL.KERNEL}
    out = {}
    for label, opts in (("float32", {}), ("bf16", dict(compute_dtype="bfloat16")), ("remat", dict(remat=True)),
                        ("bf16 + remat", dict(compute_dtype="bfloat16", remat=True))):
        state, step, _ = _g_training(dev, dataclasses.replace(MDMConfig.arch_mdm_l(), **opts), "auto")
        gen = torch.Generator(device=dev).manual_seed(0)
        for _ in range(2):  # warm-up
            step(state, db, generator=gen)
        torch.cuda.synchronize()
        _zero_counts(kernels)
        step_s, times, losses, peak = _timed_steps(lambda: step(state, db, generator=gen))
        counts = {n: k.launches for n, k in kernels.items()}
        out[label] = (step_s, peak)
        ref = out["float32"]
        print(f"G options ({label}, fused): steps {[round(x, 4) for x in times]} s, mean {step_s:.4f} s = "
              f"{TRAIN_BS / step_s:.3f} samples/s ({ref[0] / step_s:.3f}x float32's {ref[0]:.4f} s); peak "
              f"memory {peak:.2f} GiB (float32 {ref[1]:.2f}); losses {losses}; launches {counts}", flush=True)
        require(counts == {"nn_signed": 3, "dist_loss": 3}, f"G options ({label}): launches {counts} in 3 steps")
        if label in ("float32", "bf16"):  # where a full-width step's device time goes
            with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
                tr = P.DeviceTrace(tmp).start()
                for _ in range(2):
                    step(state, db, generator=gen)
                trace_summary(tr.stop(), f"G step trace ({label}, fused, 2 steps)")
        del state, step
        torch.cuda.empty_cache()
    return out


def r_option_main_path() -> dict:
    """R training at full width on the all-pairs route (arch_refine,
    dropout 0.1, batch 64 x 160 frames x 4 objects x 2048 points,
    target_h2o cached) at model.compute_dtype bfloat16 beside float32: two
    warm-up and 3 timed steps each, #1 and #4 once per step, the culled
    kernels never. -> {variant: (step s, peak GiB)}."""
    import torch

    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig

    dev = torch.device("cuda")
    kernels = _r_kernel_objects()
    out, db = {}, None
    for label, opts in (("float32", {}), ("bf16", dict(compute_dtype="bfloat16"))):
        state, step, mano, _ = _r_training(dev, dataclasses.replace(RefineConfig(), **opts), "auto")
        if db is None:
            db, _ = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, R_ALL_PAIRS_P, 11, mano, dev)
        for _ in range(2):  # warm-up
            step(state, db)
        torch.cuda.synchronize()
        _zero_counts(kernels)
        step_s, times, losses, peak = _timed_steps(lambda: step(state, db))
        counts = {n: k.launches for n, k in kernels.items()}
        out[label] = (step_s, peak)
        ref = out["float32"]
        print(f"R options ({label}, all-pairs route, {R_ALL_PAIRS_P} points): steps {[round(x, 4) for x in times]} "
              f"s, mean {step_s:.4f} s = {TRAIN_BS / step_s:.3f} samples/s ({ref[0] / step_s:.3f}x float32's "
              f"{ref[0]:.4f} s); peak memory {peak:.2f} GiB (float32 {ref[1]:.2f}); losses {losses}; launches "
              f"{counts}", flush=True)
        require(counts["h2o_nn"] == 3 and counts["h2o_nn_dvec"] == 3 and counts["h2o_cull"] == 0
                and counts["h2o_cull_dvec"] == 0, f"R options ({label}): launches {counts} in 3 steps")
        del state, step
        torch.cuda.empty_cache()
    return out


def vb_branch_parity() -> None:
    """The learned-variance and KL branches of core/diffusion on a small G
    whose model_fn emits 2C channels ([x + 0.01 G(x) | tanh(G(x))]: near x_0
    at t = 0, as a trained model is, so the t = 0 decoder NLL is well
    conditioned), GPU against CPU with the same weights, inputs and noise:
    training_losses at KL, and at MSE with LEARNED_RANGE (its vb term), on
    the full 1000-step schedule; calc_bpd_loop (FIXED_SMALL, as in JAX: the
    mean half) on 50 respaced steps. The
    tolerances of tests/test_torch_diffusion_vb.py: t > 0 terms rtol 5e-4 /
    atol 1e-4, the t = 0 terms and total_bpd rtol 2e-2."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import InteractionSegmentMDM, MDMConfig
    from oakink2_tamf_tpu_torch.parallel import train as PT

    rng = np.random.default_rng(8)
    bs, L = 4, 16
    x0 = np.clip(0.5 * rng.normal(size=(bs, L, 99)), -1, 1).astype(np.float32)
    noise = rng.normal(size=(bs, L, 99)).astype(np.float32)
    bpd_noise = rng.normal(size=(50, bs, L, 99)).astype(np.float32)
    t = np.array([0, 3, 400, 999])
    res = {}
    for dev in ("cuda", "cpu"):
        torch.manual_seed(0)
        g = InteractionSegmentMDM(MDMConfig(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, dropout=0.0))
        g = g.to(dev).eval()
        db = _train_batch(bs, L, 2, 64, seed=5, clip=FrozenClipText(device=dev), device=dev)
        gfn = PT.g_model_fn(g, PT.g_cond_from_batch(db))

        def model_fn(x, tt):
            h = gfn(x, tt)
            return torch.cat([x + 0.01 * h, torch.tanh(h)], dim=-1)

        T = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        full = D.tamf_schedule(1000).to(dev)
        with torch.no_grad():
            kl, _ = D.training_losses(model_fn, full, T(x0), T(t), db["mask"], noise=T(noise),
                                      model_var_type=D.ModelVarType.LEARNED_RANGE, loss_type=D.LossType.KL)
            mse, aux = D.training_losses(model_fn, full, T(x0), T(t), db["mask"], noise=T(noise),
                                         model_var_type=D.ModelVarType.LEARNED_RANGE)
            bpd = D.calc_bpd_loop(lambda x, tt: model_fn(x, tt)[..., :99], D.tamf_schedule(1000, "cosine", "50").to(dev),
                                  T(x0), noise=T(bpd_noise))  # FIXED_SMALL: the mean half
        res[dev] = {"kl": kl, "mse": mse, "vb": aux["vb"], **{f"bpd_{k}": v for k, v in bpd.items()}}
    late = torch.from_numpy(t > 0)
    worst = {}
    for k, want in res["cpu"].items():
        got = res["cuda"][k].cpu()
        require(bool(torch.isfinite(got).all()), f"vb branches: {k} not finite on the GPU")
        if k in ("kl", "vb"):
            pairs = ((got[late], want[late], 5e-4, 1e-4), (got[~late], want[~late], 2e-2, 0.0))
        elif want.ndim == 2:  # [bs, T] columns, the last one t = 0
            pairs = ((got[:, :-1], want[:, :-1], 5e-4, 1e-4), (got[:, -1], want[:, -1], 2e-2, 0.0))
        else:
            pairs = ((got, want, 2e-2 if k == "bpd_total_bpd" else 5e-4, 1e-4),)
        for a, b, rtol, atol in pairs:
            require(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
                    f"vb branches: {k} GPU vs CPU differ by {(a - b).abs().max().item()} (rtol {rtol})")
        worst[k] = (got - want).abs().max().item()
    print("vb branches (KL, LEARNED_RANGE vb, calc_bpd_loop on 50 steps), GPU vs CPU, largest differences: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()), flush=True)


def _busy_share(events, window) -> float:
    """The share of `window` (start, end) in microseconds covered by the
    union of the events' [ts, ts + dur) intervals."""
    spans = sorted((max(e["ts"], window[0]), min(e["ts"] + e["dur"], window[1])) for e in events)
    busy, end = 0.0, window[0]
    for a, b in spans:
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    return busy / (window[1] - window[0])


def trace_summary(path: str, label: str) -> dict:
    """Reads a Chrome trace of runtime/profiler.py: prints its five device
    operations with the most time and the device's busy share of the traced
    window (first to last event of the trace). -> {kernel name: events}."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    per_op = {}
    for e in device:
        per_op.setdefault(e["name"], []).append(e["dur"])
    window = (min(e["ts"] for e in events), max(e["ts"] + e["dur"] for e in events))
    total = sum(sum(v) for v in per_op.values())
    print(f"{label}: trace {os.path.getsize(path) / 2**20:.2f} MiB, {len(events)} complete events, {len(device)} on "
          f"the device, {total / 1e3:.3f} ms of device time", flush=True)
    for name, durs in sorted(per_op.items(), key=lambda kv: -sum(kv[1]))[:5]:
        print(f"  {label} top device op: {sum(durs) / 1e3:.3f} ms in {len(durs)} calls "
              f"({sum(durs) / max(total, 1e-9):.1%} of device time): {name[:120]}", flush=True)
    busy = _busy_share(device, window) if device else 0.0
    print(f"{label}: device busy {busy:.4f} of the traced window ({(window[1] - window[0]) / 1e3:.3f} ms)", flush=True)
    return {k: len(v) for k, v in per_op.items()}


def profile_entry_point() -> None:
    """launch/train_g.main on config/synthetic_smoke.yml for 10 epochs (20
    steps) with runtime.profile_dir set: the Chrome trace of steps 11-20
    must exist, parse and hold device events of #6 (nn_signed_kernel) and
    #8 (dist_loss_kernel), found by their symbol names. Prints the five
    device operations with the most time and the device's busy share of
    the traced window (first to last event of the trace)."""
    import tempfile

    import torch

    from oakink2_tamf_tpu_torch.launch import train_g
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        CS.KERNEL.launches = CL.KERNEL.launches = 0
        t0 = time.perf_counter()
        state = train_g.main(["--cfg", os.path.join(root, "config/synthetic_smoke.yml"), "--exp_id",
                              "chip_smoke_profile", "--train.num_epoch", "10", "--runtime.profile_dir", tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(state.step == 20, f"train_g.main (profiled) took {state.step} steps, expected 20")
        names = os.listdir(tmp)
        require(len(names) == 1 and names[0].endswith(".json"), f"profiler trace files: {names}")
        counts = trace_summary(os.path.join(tmp, names[0]), "profiled train_g.main")
    n6 = sum(n for k, n in counts.items() if "nn_signed_kernel" in k)
    n8 = sum(n for k, n in counts.items() if "dist_loss_kernel" in k)
    print(f"profiled train_g.main (synthetic_smoke.yml, 20 steps, steps 11-20 traced): {wall:.2f} s; "
          f"nn_signed_kernel events {n6}, dist_loss_kernel events {n8} (wrapper launches in the run: nn_signed "
          f"{CS.KERNEL.launches}, dist_loss {CL.KERNEL.launches})", flush=True)
    require(counts, "the profiler trace holds no device events (CUPTI saw no kernel)")
    require(n6 > 0 and n8 > 0, f"the profiler trace lacks #6 ({n6}) or #8 ({n8}) device events")


# ---------------------------------------------------------------------------
# the process group (parallel/mesh.py): one rank on NCCL, two ranks sharing
# the card on gloo, train_r.main on two ranks
# ---------------------------------------------------------------------------

DIST_REL = 1e-5  # loss rtol and each gradient's relative norm, W ranks against one rank
DIST_TIMEOUT_S = 300


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_cells(dev):
    """The full-width G cell (arch_mdm_l, fused route) and the all-pairs R
    cell (arch_refine, 2048 points) of the process-group phases, at dropout
    0 (ranks draw their masks per rank): ((g_state, g_step, g_batch,
    g_noise), (r_state, r_step, r_batch)), the same weights, batches,
    timesteps and noise in every process."""
    import torch

    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import MDMConfig
    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig

    g_state, g_step, mano = _g_training(dev, dataclasses.replace(MDMConfig.arch_mdm_l(), dropout=0.0), "auto", seed=21)
    gdb = _train_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, TRAIN_P, seed=11, clip=FrozenClipText(device=dev), device=dev)
    gen = torch.Generator().manual_seed(5)
    gdb["t"] = torch.randint(0, 1000, (TRAIN_BS,), generator=gen).to(dev)
    gdb["t_weights"] = torch.ones(TRAIN_BS, device=dev)
    noise = torch.randn((TRAIN_BS, TRAIN_L, 99), generator=gen).to(dev)
    r_state, r_step, mano, _ = _r_training(dev, RefineConfig(dropout=0.0), "auto", seed=23)
    rdb, _ = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, R_ALL_PAIRS_P, 11, mano, dev)
    return (g_state, g_step, gdb, noise), (r_state, r_step, rdb)


def _grads(state) -> dict:
    return {k: p.grad.detach().cpu().clone() for k, p in state.model.named_parameters() if p.grad is not None}


def _params_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, p in state.model.named_parameters():
        h.update(k.encode() + p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _grad_gap_rel(got: dict, want: dict) -> tuple[float, str]:
    """The largest ||got - want|| / ||want|| over the tensors, a tensor's
    norm floored at 1e-6 of the global norm (a gradient that is rounding
    noise around 0, attention's key bias, has no relative error)."""
    import torch

    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want.values())))
    worst, name = 0.0, ""
    require(set(got) == set(want), f"gradient names differ: {sorted(set(got) ^ set(want))[:4]}")
    for k, w in want.items():
        rel = float((got[k].double() - w.double()).norm()) / max(float(w.double().norm()), 1e-6 * total)
        if rel > worst:
            worst, name = rel, k
    return worst, name


def group_one_rank() -> dict:
    """(a) The full-width fused G step and the all-pairs R step under a
    process group of one rank on NCCL, against the plain step (no group) on
    the same weights, batch, t and noise: loss rtol 1e-6 and each gradient
    within 1e-6 of its norm (the same kernels; MANO's backward adds with
    atomics); 3 timed steps under the group, with 3 plain steps before the
    group and 3 after it (the card's drift between them); #6/#8 (G) and
    #1/#4 (R) once per step, the peak GiB, and the gradient all-reduce
    alone. Returns the one-rank losses and gradients that (b) is held to."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS
    from oakink2_tamf_tpu_torch.parallel import mesh

    dev = torch.device("cuda", 0)
    card = card_line()
    require(not mesh.is_live(), "a process group is already live")
    (g_state, g_step, gdb, noise), (r_state, r_step, rdb) = _dist_cells(dev)
    cells = {"G": (g_state, lambda: g_step(g_state, gdb, noise=noise), {"nn_signed": CS.KERNEL, "dist_loss": CL.KERNEL}),
             "R": (r_state, lambda: r_step(r_state, rdb), {"h2o_nn": NN.KERNEL, "h2o_nn_dvec": NN.DVEC_KERNEL})}
    plain = {}
    for label, (state, call, _) in cells.items():
        init = {k: v.clone() for k, v in state.model.state_dict().items()}
        m = call()
        plain[label] = (float(m["loss"]), _grads(state), _timed_steps(call)[0])
        state.model.load_state_dict(init)  # the group's run starts from the same weights
        state.optimizer = type(state.optimizer)(state.model.named_parameters())
        state.step = 0
    mesh.init_distributed(backend="nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0,
                          device=dev)
    out = {}
    try:
        for label, (state, call, kernels) in cells.items():
            m = call()
            loss, grads = float(m["loss"]), _grads(state)
            lp, gp, _ = plain[label]
            gap, name = _grad_gap_rel(grads, gp)
            require(abs(loss - lp) <= 1e-6 * abs(lp), f"(a) {label}: loss {loss} under the group vs {lp} plain")
            require(gap <= 1e-6, f"(a) {label}: gradient {name} {gap:.3e} of its norm from the plain step's")
            _zero_counts(kernels)
            step_s, times, _, peak = _timed_steps(call)
            counts = {n: k.launches for n, k in kernels.items()}
            require(all(v == 3 for v in counts.values()), f"(a) {label}: launches {counts} in 3 steps")
            params = state.optimizer.params
            ar_ms = cuda_time_ms(lambda: mesh.all_reduce_grads_(params), reps=10, warmup=2)
            out[label] = dict(loss=loss, grads=grads, step_s=step_s, steps_s=times, plain_step_s=plain[label][2],
                              allreduce_ms=ar_ms, peak_gib=peak, launches=counts,
                              bitwise=all(torch.equal(grads[k], gp[k]) for k in gp), grad_gap=gap,
                              elements=sum(p.numel() for p in params))
    finally:
        torch.distributed.destroy_process_group()
    for label, (state, call, _) in cells.items():
        o = out[label]
        o["plain_after_s"] = _timed_steps(call)[0]
        print(f"process group, one rank (NCCL), {label} at full width: loss {o['loss']:.6f} (plain "
              f"{plain[label][0]:.6f}), gradients "
              f"{'bitwise equal' if o['bitwise'] else 'within %.2e of their norms' % o['grad_gap']}; steps "
              f"{[round(x, 4) for x in o['steps_s']]} s, mean {o['step_s']:.4f} s = {TRAIN_BS / o['step_s']:.3f} "
              f"samples/s (plain {o['plain_step_s']:.4f} s before the group, {o['plain_after_s']:.4f} s after); peak "
              f"{o['peak_gib']:.2f} GiB; launches {o['launches']}; gradient all-reduce ({o['elements']} float32 in one "
              f"buffer) {o['allreduce_ms']:.4f} ms = {100 * o['allreduce_ms'] / (1e3 * o['step_s']):.3f}% of the "
              f"step ({card})", flush=True)
    del g_state, r_state, gdb, rdb, noise, cells
    torch.cuda.empty_cache()
    return out


def _spawn_ranks(args_for_rank, shared: str, env_for_rank=None, cwd_for_rank=None) -> list[str]:
    """Two processes of this script, started together; each must exit 0
    within DIST_TIMEOUT_S (a rank that fails fails the phase). Every process
    is stopped before this returns. -> their outputs."""
    procs = []
    try:
        for r in range(2):
            env = dict(os.environ, **(env_for_rank(r) if env_for_rank else {}))
            cwd = cwd_for_rank(r) if cwd_for_rank else shared
            os.makedirs(cwd, exist_ok=True)
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), *args_for_rank(r)], cwd=cwd,
                                          env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs, deadline = [], time.perf_counter() + DIST_TIMEOUT_S
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0])
            except subprocess.TimeoutExpired:
                outs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"rank {r} exited {p.returncode}:\n{o[-4000:]}")
    return outs


EVAL_ROWS = 16  # one global batch of the smoke config's test split
EVAL_REL = 1e-5  # each eval term, two ranks' against one process's


def smoke_eval(dev, rank: int | None = None) -> tuple[dict, dict]:
    """launch/train_g.evaluate_g on the smoke config (config/synthetic_smoke.yml:
    its G with weights from seed 0, DDPM at its 8 steps, the extra loss at
    ExtraLossConfig's coefficients through #6/#8) over one global batch of
    the first EVAL_ROWS test segments, collated explicitly: all of them, or
    rank `rank`'s rows [8 r, 8 r + 8) under a live group of 2; the sampling
    generator seeded 0 in every process. -> (terms, the launches of #6/#8)."""
    import argparse

    import torch

    from oakink2_tamf_tpu_torch.core import diffusion as D
    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
    from oakink2_tamf_tpu_torch.launch import common, param, train_g
    from oakink2_tamf_tpu_torch.models import losses as LL
    from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS
    from oakink2_tamf_tpu_torch.parallel import train as PT
    from oakink2_tamf_tpu_torch.runtime.config import ConfigRegistry

    reg = ConfigRegistry("train_g")
    for fn in (param.reg_base_param, param.reg_model_param, param.reg_diffusion_param):
        fn(reg)
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    smoke = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "synthetic_smoke.yml")
    reg.parse(parser, ["--cfg", smoke])
    torch.manual_seed(0)
    model = train_g.build_model(reg).to(dev)
    sched = D.tamf_schedule(int(reg.select("diffusion").get("steps", 1000))).to(dev)
    data_cfg = reg.select("data")
    ds = common.build_dataset(reg, "test")
    rows = range(EVAL_ROWS) if rank is None else range(rank * EVAL_ROWS // 2, (rank + 1) * EVAL_ROWS // 2)
    batch = SegmentCollate(max_nobj=int(data_cfg.get("max_nobj", 4)),
                           n_obj_points=int(data_cfg.get("n_obj_points", 2048)))([ds[i] for i in rows])
    mano = stack_mano_models(M.get_mano_model(None, "right"), M.get_mano_model(None, "left"), dev)
    kernels = {"nn_signed": CS.KERNEL, "dist_loss": CL.KERNEL}
    _zero_counts(kernels)
    terms = train_g.evaluate_g(PT.make_g_sampler(sched), model, mano, LL.load_contact_assets(device=dev),
                               LL.ExtraLossConfig(), [batch], common.build_clip(reg, dev), dev,
                               torch.Generator(device=dev).manual_seed(0))
    return terms, {n: k.launches for n, k in kernels.items()}


def _two_rank_worker(shared: str, rank: int) -> None:
    """(b)'s rank: the G and R cells on cuda:0 in a gloo group of 2, rows
    [32 r, 32 r + 32) of the same 64; one step each with its loss and
    gradients, a second step, the parameters' digest and the launch counts
    written to shared/rank{r}.pt."""
    import torch

    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS
    from oakink2_tamf_tpu_torch.parallel import mesh

    dev = torch.device("cuda", 0)
    mesh.init_distributed(backend="gloo", init_method="file://" + os.path.join(shared, "rendezvous"),
                          world_size=2, rank=rank, device=dev)
    (g_state, g_step, gdb, noise), (r_state, r_step, rdb) = _dist_cells(dev)
    rows = slice(rank * TRAIN_BS // 2, (rank + 1) * TRAIN_BS // 2)
    gdb = {k: v[rows] for k, v in gdb.items()}
    rdb = {k: v[rows] for k, v in rdb.items()}
    res = {}
    for label, state, call, kernels in (
            ("G", g_state, lambda s: g_step(s, gdb, noise=noise[rows]), {"nn_signed": CS.KERNEL, "dist_loss": CL.KERNEL}),
            ("R", r_state, lambda s: r_step(s, rdb), {"h2o_nn": NN.KERNEL, "h2o_nn_dvec": NN.DVEC_KERNEL})):
        _zero_counts(kernels)
        t0 = time.perf_counter()
        m = call(state)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        res[label] = dict(loss=float(m["loss"]), grads=_grads(state))
        t0 = time.perf_counter()
        call(state)
        torch.cuda.synchronize()
        res[label]["second_step_s"] = time.perf_counter() - t0
        res[label]["launches"] = {n: k.launches for n, k in kernels.items()}
        res[label]["digest"] = _params_digest(state)
        params = state.optimizer.params
        res[label]["allreduce_ms"] = cuda_time_ms(lambda: mesh.all_reduce_grads_(params), reps=3)
        print(f"rank {rank}: {label} on {TRAIN_BS // 2} of {TRAIN_BS} rows: loss {res[label]['loss']:.6f}, steps "
              f"{first:.3f} / {res[label]['second_step_s']:.3f} s, launches in 2 steps {res[label]['launches']}, "
              f"gloo all-reduce {res[label]['allreduce_ms']:.3f} ms", flush=True)
    t0 = time.perf_counter()
    res["eval"], res["eval_launches"] = smoke_eval(dev, rank)
    print(f"rank {rank}: evaluate_g on {EVAL_ROWS // 2} of {EVAL_ROWS} rows in {time.perf_counter() - t0:.2f} s, "
          f"launches {res['eval_launches']}", flush=True)
    torch.save(res, os.path.join(shared, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def group_two_ranks(one: dict) -> None:
    """(b) Two processes sharing cuda:0 in a gloo group (NCCL refuses two
    ranks on one card), each with 32 of the same 64 rows, on the full-width
    G step and the all-pairs R step: each rank's loss within rtol 1e-5 of
    (a)'s one-rank step and each gradient within 1e-5 of its norm; the
    ranks' parameters bitwise equal after 2 steps; #6/#8 and #1/#4 once per
    step on each rank. Then each rank's G eval pass (smoke_eval) on its 8 of
    16 global rows: every term within rtol EVAL_REL of one process's on the
    16, #6 and #8 launched on both ranks."""
    import tempfile

    import torch

    card = card_line()
    t0 = time.perf_counter()
    eval_one, eval_launches = smoke_eval(torch.device("cuda", 0))
    eval_one_s = time.perf_counter() - t0
    require(all(v > 0 for v in eval_launches.values()), f"(b) evaluate_g in one process: launches {eval_launches}")
    with tempfile.TemporaryDirectory(prefix="tamf_ranks_") as shared:
        t0 = time.perf_counter()
        outs = _spawn_ranks(lambda r: ["--two-rank-worker", shared, str(r)], shared)
        wall = time.perf_counter() - t0
        res = [torch.load(os.path.join(shared, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    for o in outs:
        print("\n".join(ln for ln in o.splitlines() if ln.startswith("rank ")), flush=True)
    for label, kernels in (("G", ("nn_signed", "dist_loss")), ("R", ("h2o_nn", "h2o_nn_dvec"))):
        want = one[label]
        gaps = []
        for r in range(2):
            got = res[r][label]
            require(abs(got["loss"] - want["loss"]) <= DIST_REL * abs(want["loss"]),
                    f"(b) {label} rank {r}: loss {got['loss']} vs one rank's {want['loss']}")
            gap, name = _grad_gap_rel(got["grads"], want["grads"])
            require(gap <= DIST_REL, f"(b) {label} rank {r}: gradient {name} {gap:.3e} of its norm from one rank's")
            require(all(got["launches"][k] == 2 for k in kernels), f"(b) {label} rank {r}: {got['launches']}")
            gaps.append((gap, name))
        require(res[0][label]["digest"] == res[1][label]["digest"],
                f"(b) {label}: the ranks' parameters differ after 2 steps")
        print(f"two ranks sharing the card (gloo), {label}: losses {res[0][label]['loss']:.6f} / "
              f"{res[1][label]['loss']:.6f} (one rank {want['loss']:.6f}); gradients within "
              f"{max(gaps)[0]:.2e} of their norms (worst {max(gaps)[1]}); parameters bitwise equal after 2 steps; second steps "
              f"{res[0][label]['second_step_s']:.3f} / {res[1][label]['second_step_s']:.3f} s on the shared card "
              f"(one rank alone {want['step_s']:.4f} s); gloo all-reduce {res[0][label]['allreduce_ms']:.3f} ms; "
              f"both ranks {wall:.1f} s ({card})", flush=True)
    gap = 0.0
    for r in range(2):
        got = res[r]["eval"]
        require(set(got) == set(eval_one), f"(b) evaluate_g rank {r}: terms {sorted(got)} vs {sorted(eval_one)}")
        for k, v in eval_one.items():
            rel = abs(got[k] - v) / max(abs(v), 1e-12)
            require(rel <= EVAL_REL, f"(b) evaluate_g rank {r}: {k} {got[k]} vs one process's {v}")
            gap = max(gap, rel)
        require(all(v > 0 for v in res[r]["eval_launches"].values()),
                f"(b) evaluate_g rank {r}: launches {res[r]['eval_launches']}")
    print(f"two ranks sharing the card (gloo), G eval pass (evaluate_g, smoke config, DDPM): each rank's terms on its "
          f"{EVAL_ROWS // 2} of {EVAL_ROWS} rows within {gap:.2e} (relative) of one process's on the {EVAL_ROWS} "
          f"({', '.join(f'{k} {v:.6g}' for k, v in sorted(eval_one.items()))}); one process {eval_one_s:.2f} s, "
          f"launches {eval_launches}; rank launches {[res[r]['eval_launches'] for r in range(2)]} ({card})",
          flush=True)


def _train_r_worker(shared: str) -> None:
    """(c)'s rank, started with torchrun's environment: train_r.main on the
    smoke config on cuda:0 over gloo, its kernels built cold into a build
    dir both ranks share; the parameters' digest to shared/train_r{rank}.pt."""
    import torch

    from oakink2_tamf_tpu_torch.launch import train_r
    from oakink2_tamf_tpu_torch.ops import _build
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    _build.BUILD_DIR = os.path.join(shared, "build")
    smoke = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config", "synthetic_smoke.yml")
    state = train_r.main(["--cfg", smoke, "--runtime.device", "cuda:0", "--runtime.dist_backend", "gloo",
                          "--exp_id", "dist_r", "--train.num_epoch", "1", "--train.val_freq", "1",
                          "--train.eval_max_batches", "1", "--commit",
                          "--train.data.target_h2o_cache_dir", os.path.join(shared, "h2o_cache")])
    rank = torch.distributed.get_rank()
    torch.save({"step": state.step, "digest": _params_digest(state),
                "launches": {"h2o_nn": NN.KERNEL.launches, "h2o_nn_dvec": NN.DVEC_KERNEL.launches}},
               os.path.join(shared, f"train_r{rank}.pt"))
    torch.distributed.destroy_process_group()


def train_r_two_ranks() -> None:
    """(c) launch/train_r.main on two ranks through torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), both on
    cuda:0 over gloo: the smoke config, 1 epoch, val_freq 1, a shared
    target_h2o_cache_dir, --commit, the kernels built cold by both ranks
    into one dir. The ranks' parameters bitwise equal; the striped cache
    complete (16 files and meta.json); only rank 0 writes save/ and the
    eval line."""
    import tempfile

    import torch

    card = card_line()
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="tamf_train_r_") as shared:
        t0 = time.perf_counter()
        outs = _spawn_ranks(
            lambda r: ["--train-r-worker", shared], shared,
            env_for_rank=lambda r: dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                                        MASTER_PORT=str(port)),
            cwd_for_rank=lambda r: os.path.join(shared, f"rank{r}"))
        wall = time.perf_counter() - t0
        res = [torch.load(os.path.join(shared, f"train_r{r}.pt"), weights_only=False) for r in range(2)]
        cache = os.listdir(os.path.join(shared, "h2o_cache"))
        build = os.path.join(shared, "build")
        built = sorted(f for f in os.listdir(build) if f.endswith(".so")) if os.path.isdir(build) else []
        runs = [os.path.join(shared, f"rank{r}", "common", "train_r", "dist_r") for r in range(2)]
        saved = [sorted(os.listdir(os.path.join(d, "save"))) if os.path.isdir(os.path.join(d, "save")) else []
                 for d in runs]
    require(res[0]["step"] == res[1]["step"] == 1, f"(c) steps {res[0]['step']} / {res[1]['step']}")
    require(res[0]["digest"] == res[1]["digest"], "(c) the ranks' parameters differ")
    npy = [f for f in cache if f.endswith(".npy")]
    require(len(npy) == 16 and "meta.json" in cache, f"(c) the shared cache holds {sorted(cache)}")
    require(saved == [["model_0000.pt"], []], f"(c) save/ per rank: {saved}")
    require("val epoch 0000 refine eval" in outs[0] and "refine eval" not in outs[1],
            "(c) the eval line is not rank 0's alone")
    require(all(r["launches"]["h2o_nn"] > 0 and r["launches"]["h2o_nn_dvec"] > 0 for r in res),
            f"(c) launches {[r['launches'] for r in res]}")
    require(sorted(f.split("-")[0] for f in built) == ["h2o_nn", "h2o_nn_dvec"], f"(c) built cold: {built}")
    print(f"train_r.main on two ranks (gloo on cuda:0, torchrun environment): {wall:.1f} s; parameters bitwise "
          f"equal after {res[0]['step']} step; the shared cache {len(npy)} files + meta.json; save/ "
          f"{saved[0]} on rank 0, none on rank 1; kernels built cold by both ranks into one dir: {built}; "
          f"launches per rank {[r['launches'] for r in res]} ({card})", flush=True)


POINTBERT_BATCHES = (16, 64)
POINTBERT_REL = 1e-4  # the card's embedding against the CPU's, of the CPU embedding's max-abs


def _pointbert_model():
    """(PointTransformer at PointBertConfig's defaults in eval mode on the
    CPU, weights from seed 0 as compute_obj_assets makes them, its copy on
    the card)."""
    import copy

    import torch

    from oakink2_tamf_tpu_torch.models import pointbert as PB

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cpu = PB.PointTransformer(PB.PointBertConfig()).eval().requires_grad_(False)
    return cpu, copy.deepcopy(cpu).to("cuda")


def pointbert_clouds(B: int, n_points: int = 8192):
    """B object clouds [B, n_points, 3] on the CPU: the box toolkit's
    surface samples (data/fabricate.py), one box per cloud."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.data.fabricate import box_surface_points

    return torch.from_numpy(np.stack([box_surface_points(f"obj_{i:03d}", n_points) for i in range(B)]))


def pointbert_path() -> dict:
    """The PointBERT tower at full width (phase 24): FPS indices and the
    embeddings of 2 clouds on the card against the CPU; then at each of
    POINTBERT_BATCHES the stages timed with CUDA events (3 runs after a
    warm-up): FPS, knn grouping on FPS's centres, the tokenizer on the
    groups, the transformer on the tokens, the whole call; the clouds per
    second, FPS's share of the whole, the peak GiB; FPS on one cloud and
    the host time of its enqueue."""
    import torch

    from oakink2_tamf_tpu_torch.models import pointbert as PB

    card = card_line()
    cpu, model = _pointbert_model()
    cfg = model.cfg
    dev = torch.device("cuda")
    clouds = pointbert_clouds(max(POINTBERT_BATCHES))
    t0 = time.perf_counter()
    idx_cpu = PB.farthest_point_sampling(clouds[:2], cfg.num_group)
    cpu_fps_s = time.perf_counter() - t0
    idx_gpu = PB.farthest_point_sampling(clouds[:2].to(dev), cfg.num_group).cpu()
    require(torch.equal(idx_gpu, idx_cpu), f"FPS: the card picks {int((idx_gpu != idx_cpu).sum())} other points")
    with torch.inference_mode():
        want = cpu(clouds[:2])
        got = model(clouds[:2].to(dev)).cpu()
    require(got.shape == (2, 2 * cfg.trans_dim) and bool(torch.isfinite(got).all()), f"embedding {tuple(got.shape)}")
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    require(err <= POINTBERT_REL * scale, f"embedding on the card {err:.3e} from the CPU's (max-abs {scale:.4f})")
    print(f"PointBERT at full width (8192 points, {cfg.num_group} groups of {cfg.group_size}, depth {cfg.depth}, "
          f"width {cfg.trans_dim}, {cfg.num_heads} heads): FPS indices of 2 clouds equal on the card and the CPU "
          f"(CPU {cpu_fps_s:.2f} s); embeddings within {err:.3e} of the CPU's (max-abs {scale:.4f}, bound "
          f"{POINTBERT_REL:g} of it) ({card})", flush=True)
    out = {"card": card, "emb_max_abs_err": err, "emb_max_abs": scale, "batches": {}}
    with torch.inference_mode():
        for B in POINTBERT_BATCHES:
            x = clouds[:B].to(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            emb = model(x)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            require(emb.shape == (B, 2 * cfg.trans_dim) and bool(torch.isfinite(emb).all()), f"batch {B}: {emb.shape}")
            idx = PB.farthest_point_sampling(x, cfg.num_group)
            centers = torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))
            neigh, _ = PB.knn_group(x, centers, cfg.group_size)
            tokens = model.tokenize(neigh)
            ms = {"fps": cuda_time_ms(lambda: PB.farthest_point_sampling(x, cfg.num_group), reps=3),
                  "knn": cuda_time_ms(lambda: PB.knn_group(x, centers, cfg.group_size), reps=3),
                  "tokenizer": cuda_time_ms(lambda: model.tokenize(neigh), reps=3),
                  "transformer": cuda_time_ms(lambda: model.transform(tokens, centers), reps=3),
                  "whole": cuda_time_ms(lambda: model(x), reps=3)}
            rate = B / ms["whole"] * 1e3
            out["batches"][B] = dict(ms=ms, clouds_per_s=rate, peak_gib=peak)
            print(f"PointBERT batch {B}: FPS {ms['fps']:.3f} ms ({100 * ms['fps'] / ms['whole']:.1f}% of the whole), "
                  f"knn {ms['knn']:.3f} ms, tokenizer {ms['tokenizer']:.3f} ms, transformer "
                  f"{ms['transformer']:.3f} ms, whole {ms['whole']:.3f} ms = {rate:.1f} clouds/s; peak {peak:.2f} GiB "
                  f"({card})", flush=True)
            del x, idx, centers, neigh, tokens, emb
        one = clouds[:1].to(dev)
        fps1 = cuda_time_ms(lambda: PB.farthest_point_sampling(one, cfg.num_group), reps=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        PB.farthest_point_sampling(one, cfg.num_group)
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    out.update(fps_one_cloud_ms=fps1, fps_one_cloud_host_ms=host)
    print(f"PointBERT FPS of one 8192-point cloud: {fps1:.3f} ms on the card for {cfg.num_group} steps "
          f"({1e3 * fps1 / cfg.num_group:.2f} us per step); its host enqueue {host:.3f} ms ({card})", flush=True)
    torch.cuda.empty_cache()
    return out


def obj_assets_entry_point() -> None:
    """launch/compute_obj_assets.main on the card (its default device) on 3
    box meshes written to a temporary dir (phase 25): the clouds equal to
    mesh_io.sample_surface's (seed 0), 3 finite 768-d embeddings, the first
    within POINTBERT_REL of the CPU tower's on the same cloud."""
    import tempfile

    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.data.fabricate import BOX_FACES, box_verts
    from oakink2_tamf_tpu_torch.launch import compute_obj_assets
    from oakink2_tamf_tpu_torch.models import pointbert as PB
    from oakink2_tamf_tpu_torch.utils import mesh_io

    oids = [f"obj_{i:03d}" for i in range(3)]
    with tempfile.TemporaryDirectory(prefix="tamf_obj_assets_") as tmp:
        mesh_dir, pc, emb = (os.path.join(tmp, d) for d in ("meshes", "pc", "emb"))
        os.makedirs(mesh_dir)
        for oid in oids:
            mesh_io.save_obj(os.path.join(mesh_dir, f"{oid}.obj"), box_verts(oid), BOX_FACES)
        t0 = time.perf_counter()
        got = compute_obj_assets.main(["--mesh_dir", mesh_dir, "--out_pointcloud", pc, "--out_embedding", emb,
                                       "--commit"])
        wall = time.perf_counter() - t0
        require(got == oids, f"compute_obj_assets embedded {got}")
        clouds, embs = [], []
        for oid in oids:
            v, f = mesh_io.load_obj(os.path.join(mesh_dir, f"{oid}.obj"))
            pts = np.load(os.path.join(pc, f"{oid}.npz"))["point"]
            require(np.array_equal(pts, mesh_io.sample_surface(v, f, 8192)), f"{oid}: the cloud differs")
            e = np.load(os.path.join(emb, f"{oid}.npy"))
            require(e.shape == (768,) and e.dtype == np.float32 and np.isfinite(e).all(), f"{oid}: {e.shape}")
            clouds.append(pts)
            embs.append(e)
    cpu, _ = _pointbert_model()
    want = PB.compute_object_embedding(cpu, clouds[0])
    err, scale = float(np.abs(embs[0] - want).max()), float(np.abs(want).max())
    require(err <= POINTBERT_REL * scale, f"compute_obj_assets: {oids[0]} {err:.3e} from the CPU's")
    print(f"compute_obj_assets.main on the card: {len(oids)} meshes in {wall:.2f} s (tower built and weights made "
          f"included); clouds equal to sample_surface's; {oids[0]}'s embedding within {err:.3e} of the CPU's "
          f"(max-abs {scale:.4f}) ({card_line()})", flush=True)


# ---------------------------------------------------------------------------
# The streaming xla route, vertex normals' scatter route, R at
# h2o_backend xla, the debug and data launchers (phase 26)
# ---------------------------------------------------------------------------

XLA_FRAMES = 32  # frames of the xla route's checks, one cloud each, 778 x 8192
DEBUG_SEGMENTS = 16  # debug_refine's synthetic segments on the card


def _all_kernels() -> dict:
    """Every kernel object of the port, by name."""
    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_h2o_bwd as HB
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    ks = (NN.KERNEL, CU.KERNEL, CS.KERNEL, CS.BWD_KERNEL, CL.KERNEL, NN.DVEC_KERNEL, CU.DVEC_KERNEL, HB.KERNEL,
          *CC.KERNELS, CL.CULL_KERNEL, CU.MASK_KERNEL)
    return {k.name: k for k in ks}


def xla_close(got, want, *clouds, same=None) -> str:
    """'' when got matches want as tests/test_torch_geometry_xla.py holds
    the xla route: the same +-inf/nan places, the same signs where the two
    searches chose the same point (`same`, a bool mask; everywhere when
    None: at a near-tie the card and the CPU may choose different points,
    whose normals sign differently), and each distance within rtol 1e-5 or
    its square within 4 float32 ulps of max|x|^2 + max|y|^2 (the uncentred
    expansion rounds x.y per BLAS); else what differs."""
    import torch

    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    fin = torch.isfinite(want)
    if not (torch.equal(torch.isfinite(got), fin) and torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(got[torch.isinf(want)].abs(), want[torch.isinf(want)].abs())):
        return "inf/nan places differ"
    keep = fin if same is None else fin & same.cpu()
    if not torch.equal(torch.sign(got[keep]), torch.sign(want[keep])):
        return "signs differ where the same point was chosen"
    g, w = got[fin].abs(), want[fin].abs()
    atol = 4 * torch.finfo(torch.float32).eps * sum(float(c.double().square().sum(-1).max()) for c in clouds)
    bad = ~(((g - w).abs() <= 1e-5 * w.abs()) | ((g * g - w * w).abs() <= atol))
    return f"{int(bad.sum())} of {bad.numel()} beyond rtol 1e-5 and {atol:.3g} m^2" if bad.any() else ""


def xla_route() -> dict:
    """The streaming xla route (core/geometry backend="xla") at 32 frames x
    778 x 8192 with a ragged and an all-invalid cloud (kernel_inputs):
    point2point_signed with both normals, and point2point_h2o(grad_y=True)
    under autograd, on the card against the CPU (values as xla_close,
    gradients within 1e-4 of their norms), no kernel launched inside the
    route, the search's values bitwise the same at a 16 MiB tile budget;
    then against #6 (the signed pair) and #1 (the all-pairs h2o search) on
    the same operands' frames with a valid point: squared distances within
    1e-6 m^2 (uncentred against pinned arithmetic), the share of equal
    indices printed; #6 and #1 must launch there. Times of each."""
    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.core import geometry as G
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    x, y, yv, _, _ = kernel_inputs(8192, G=XLA_FRAMES, L=1, seed=26)
    rng = np.random.default_rng(26)
    xn, yn, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
                 for s in (x.shape, y.shape, x.shape[:2]))
    kernels = _all_kernels()

    def run(dev):
        a = [t.to(dev) for t in (x, y, yv, xn, yn, w)]
        signed = G.point2point_signed(a[0], a[1], a[3], a[2], backend="xla", y_normals=a[4])
        xg, yg = a[0].clone().requires_grad_(True), a[1].clone().requires_grad_(True)
        d = G.point2point_h2o(xg, yg, a[2], backend="xla")
        (torch.where(torch.isfinite(d), d, 0.0) * a[5]).sum().backward()
        return signed, d, xg.grad, yg.grad

    _zero_counts(kernels)
    (signed, d, gx, gy), ms = cuda_timed(lambda: run("cuda"))
    counts = {n: k.launches for n, k in kernels.items()}
    require(not any(counts.values()), f"xla route: kernels launched inside it: {counts}")
    t0 = time.perf_counter()
    c_signed, c_d, c_gx, c_gy = run("cpu")
    cpu_s = time.perf_counter() - t0
    i_x2y = G.nearest_neighbor(x, y, yv)[1].cpu()
    same_x2y = i_x2y == G.nearest_neighbor(x.cpu(), y.cpu(), yv.cpu())[1]
    same_y2x = signed[2].cpu() == c_signed[2]
    for name, a, b, same in (("y2x", signed[0], c_signed[0], same_y2x), ("x2y", signed[1], c_signed[1], same_x2y),
                             ("h2o", d, c_d, same_x2y)):
        err = xla_close(a, b, x, y, same=same)
        require(not err, f"xla route {name}, card vs CPU: {err}")
    idx_share = float(same_y2x.double().mean())
    h2o_share = float(same_x2y.double().mean())
    # gradients where both chose the same pairs: gx on those rows, gy on the
    # frames (clouds) whose every row did
    grads = {}
    frames = same_x2y.all(1)
    require(int(frames.sum()) >= XLA_FRAMES // 2, f"xla route: only {int(frames.sum())} frames with every pair the same")
    for name, a, b in (("gx", gx.cpu()[same_x2y], c_gx[same_x2y]), ("gy", gy.cpu()[frames], c_gy[frames])):
        gap = float((a.double() - b.double()).norm() / b.double().norm())
        require(gap <= 1e-4, f"xla route {name}: card vs CPU {gap:.3e} of its norm")
        grads[name] = gap
    dead = ~yv.any(1)
    require(bool(torch.isinf(d[dead]).all()) and bool((signed[0][dead] == 0).all()),
            "xla route: the all-invalid cloud is not inf (x2y) and 0 (y2x)")
    small = G.nearest_neighbor(x, y, yv, tile_bytes=1 << 24)
    full = G.nearest_neighbor(x, y, yv)
    require(all(torch.equal(a, b) for a, b in zip(small, full)), "xla search: values depend on the tile budget")
    print(f"xla route ({XLA_FRAMES} x 778 x 8192, ragged and all-invalid clouds): signed with both normals and h2o "
          f"forward+backward {ms:.3f} ms on the card, {cpu_s:.2f} s on the CPU; values within xla_close, equal "
          f"indices o2h {idx_share:.6f}, h2o {h2o_share:.6f}; gx {grads['gx']:.2e} (same rows), gy {grads['gy']:.2e} "
          f"({int(frames.sum())} of {XLA_FRAMES} frames with every pair the same) of their norms; no kernel launched; "
          f"the same bitwise at a 16 MiB tile ({card_line()})", flush=True)

    # against #6 and #1 on the frames whose cloud has a valid point
    live = yv.any(1)
    with torch.no_grad():
        xla_s, xla_ms = cuda_timed(lambda: G.point2point_signed(x, y, xn, yv, backend="xla"))
        xla_h, xla_h_ms = cuda_timed(lambda: G.nearest_neighbor(x, y, yv))
        _zero_counts(kernels)
        k6, k6_ms = cuda_timed(lambda: G.point2point_signed(x, y, xn, yv))
        k1, k1_ms = cuda_timed(lambda: NN.h2o_nn(x, y, yv, 1))
    counts = {n: k.launches for n, k in kernels.items()}
    require(counts["nn_signed"] >= 1 and counts["h2o_nn"] >= 1, f"xla vs kernels: #6/#1 did not launch: {counts}")
    gaps, shares = {}, {}
    for name, a2, b2 in (("x2y vs #6", xla_s[1].square(), k6[1].square()),
                         ("y2x vs #6", xla_s[0].square(), k6[0].square()), ("h2o vs #1", xla_h[0], k1[0])):
        gap = float((a2[live].double() - b2[live].double()).abs().max())
        require(gap <= 1e-6, f"xla route {name}: squared distances differ by {gap:.3e} m^2")
        gaps[name] = gap
    shares["o2h"] = float((xla_s[2][live] == k6[2][live]).double().mean())
    shares["h2o"] = float((xla_h[1][live] == k1[1][live]).double().mean())
    print(f"xla route against the kernels on {int(live.sum())} live frames: worst squared-distance gap "
          + ", ".join(f"{k} {v:.3e} m^2" for k, v in gaps.items())
          + f"; equal indices o2h {shares['o2h']:.6f}, h2o {shares['h2o']:.6f}; signed pair xla {xla_ms:.3f} ms vs "
          f"#6 {k6_ms:.3f} ms; h2o search xla {xla_h_ms:.3f} ms vs #1 {k1_ms:.3f} ms ({card_line()})", flush=True)
    return dict(ms=ms, cpu_s=cpu_s, grads=grads, gaps=gaps, index_shares=shares, signed_xla_ms=xla_ms,
                signed_nn_ms=k6_ms, h2o_xla_ms=xla_h_ms, h2o_nn_ms=k1_ms)


def heightfield(n: int, seed: int = 0):
    """A bumpy n x n grid surface: (verts [n^2, 3] float32, faces
    [2 (n-1)^2, 3] int32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.linspace(0, 0.2, n), np.linspace(0, 0.2, n), indexing="ij")
    z = 0.02 * np.sin(30 * u) * np.cos(20 * v) + 0.002 * rng.normal(size=u.shape)
    verts = np.stack([u, v, z], -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(n - 1)
    a = (i[:, None] * n + i[None, :]).reshape(-1)
    faces = np.concatenate([np.stack([a, a + n, a + 1], 1), np.stack([a + 1, a + n, a + n + 1], 1)])
    return verts, faces.astype(np.int32)


def normals_and_mano_sides() -> dict:
    """core/geometry.vertex_normals on an object-sized mesh (100 x 100 grid:
    10000 verts x 19602 faces) for 8 poses under autograd, card against CPU
    within 1e-5; then MANO on each row's own side (models/refine_r
    .batch_recover_mano with normals) at R's shape, 64 x 160 frames with the
    sides mixed, card against CPU: verts and joints within 1e-5 m, normals
    within 1e-3 (the synthetic hand's sliver faces), and its ms."""
    import torch

    from oakink2_tamf_tpu_torch.core import geometry as G
    from oakink2_tamf_tpu_torch.core import transforms as T
    from oakink2_tamf_tpu_torch.models.refine_r import batch_recover_mano

    verts, faces = heightfield(100, seed=26)
    vb = torch.from_numpy(verts)[None] * torch.linspace(0.5, 1.5, 8)[:, None, None]
    vc = vb.cuda().requires_grad_(True)
    G.vertex_normals(vc.detach(), faces)  # the first launches load the kernels
    n, ms = cuda_timed(lambda: G.vertex_normals(vc, faces))
    n.sum().backward()
    with torch.no_grad():
        want = G.vertex_normals(vb, faces)
    err = float((n.detach().cpu() - want).abs().max())
    require(err <= 1e-5 and bool(torch.isfinite(vc.grad).all()), f"vertex normals scatter route: {err:.3e}")
    print(f"vertex_normals scatter route (8 x 10000 verts x 19602 faces): {ms:.3f} ms on the card, within "
          f"{err:.3e} of the CPU; finite gradient ({card_line()})", flush=True)

    g = torch.Generator().manual_seed(26)
    bs, L = TRAIN_BS, TRAIN_L
    rot = T.rotmat_to_rot6d(T.quat_to_rotmat(torch.randn(bs, L, 16, 4, generator=g))).reshape(bs, L, 96)
    pose = torch.cat([0.1 * torch.randn(bs, L, 3, generator=g), rot], -1)
    shape = torch.randn(bs, L, 10, generator=g)
    side = torch.arange(bs) % 2
    got, mano_ms = {}, {}
    for dev in ("cpu", "cuda"):
        mano, _ = _r_geometry(torch.device(dev))
        args = (mano, pose.to(dev), shape.to(dev), side.to(dev))
        with torch.no_grad():
            got[dev] = batch_recover_mano(*args, normals=True)
    for normals in (False, True):
        mano_ms[normals] = cuda_time_ms(lambda: batch_recover_mano(*args, normals=normals), reps=5)
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(got["cuda"], got["cpu"])]
    require(errs[0] <= 1e-5 and errs[1] <= 1e-5 and errs[2] <= 1e-3, f"MANO per side, card against CPU: {errs}")
    print(f"batch_recover_mano ({bs} x {L} frames, sides mixed): {mano_ms[False]:.3f} ms, with normals "
          f"{mano_ms[True]:.3f} ms on the card; verts / joints / normals within {errs} of the CPU "
          f"({card_line()})", flush=True)
    return dict(ms=ms, max_abs_err=err, mano_ms=mano_ms[False], mano_normals_ms=mano_ms[True], mano_errs=errs)


def r_xla_main_path(all_pairs_step_s: float) -> dict:
    """R training at full width on h2o_backend "xla" (arch_refine, batch 64
    x 160 frames x 4 objects x 2048 points, target_h2o cached, sample from
    the Gaussian-perturb adaptor): one warm-up and 3 timed steps, peak GiB,
    no kernel launched in the steps; printed beside the all-pairs route's
    step (phase 11). Then the step's two searches alone on the same batch
    (the sample hand's verts as operands of both): the sample h2o without
    gradient and the refined h2o forward+backward."""
    import torch

    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig, batch_recover_mano, multi_object_h2o_dist

    label = f"R main path (xla route, {R_ALL_PAIRS_P} points)"
    dev = torch.device("cuda")
    state, step, mano, _ = _r_training(dev, RefineConfig(), "xla")
    db, _ = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, R_ALL_PAIRS_P, 11, mano, dev)
    t0 = time.perf_counter()
    step(state, db)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    kernels = _all_kernels()
    before = [p.detach().clone() for p in state.model.parameters()]
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
    require(not any(counts.values()), f"{label}: kernels launched: {counts}")
    require(all(v == v and abs(v) < float("inf") for v in losses), f"{label}: non-finite training loss")
    require(any(not torch.equal(a, b) for a, b in zip(before, state.model.parameters())),
            f"{label}: parameters unchanged")
    print(f"{label}: warm-up {warm:.3f} s; steps {[round(t, 4) for t in times]} s, mean {step_s:.4f} s = "
          f"{TRAIN_BS / step_s:.3f} samples/s (the all-pairs route's step {all_pairs_step_s:.4f} s: "
          f"{step_s / all_pairs_step_s:.2f}x); losses {losses}; peak memory {peak:.2f} GiB; no kernel launched "
          f"({card_line()})", flush=True)
    del before

    mask = db["mask"]
    with torch.no_grad():
        verts = batch_recover_mano(mano, db["sample_pose_repr"], db["shape"], db["hand_side"])[0]

    def h2o(v):
        return multi_object_h2o_dist(v, db["obj_traj"], db["obj_points"], db["obj_mask"], frame_mask=mask,
                                     backend="xla")

    def sample_h2o():
        with torch.no_grad():
            h2o(verts)

    def refined_h2o():
        (h2o(verts.clone().requires_grad_(True)) * mask[:, :, None]).sum().backward()

    split = {"sample h2o (no grad)": cuda_time_ms(sample_h2o, reps=2),
             "refined h2o forward+backward": cuda_time_ms(refined_h2o, reps=2)}
    print(f"R step split (xla route, {R_ALL_PAIRS_P} points) (ms, each alone on the same batch): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    del state, db, verts
    torch.cuda.empty_cache()
    return dict(step_s=step_s, times=times, peak_gib=peak, all_pairs_step_s=all_pairs_step_s, split_ms=split)


def debug_launchers() -> dict:
    """The debug and data launchers on the card, each writing into a
    temporary dir: launch/debug_refine at arch_refine widths on 16 synthetic
    segments collated at 4 slots x 8192 points (#2 must launch: the culled
    route of the sample, refined and target h2o), launch/debug_sample at
    arch_mdm_l on 2 samples with the 1000-step DDPM chain, launch/viz_seg
    and launch/save_cache_dict on the smoke config; wall seconds each. The
    three renderers run with --html true: the HTML viewers (numpy only) are
    written as they are; where matplotlib is not installed (the card's
    machine has none) the PNG figures are not drawn: the arrays handed to
    each figure are recorded instead and must be finite."""
    import importlib.util
    import tempfile
    from contextlib import ExitStack
    from unittest import mock

    import numpy as np

    from oakink2_tamf_tpu_torch.launch import debug_refine, debug_sample, save_cache_dict, viz_seg

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = lambda name: os.path.join(root, "config", name)  # noqa: E731
    kernels = _all_kernels()
    drawn = importlib.util.find_spec("matplotlib") is not None
    figures = []

    def record(*arrays, **kw):
        arrs = [np.asarray(a) for a in (*arrays, *kw.values()) if a is not None and not isinstance(a, str)]
        require(all(np.isfinite(a).all() for a in arrs if a.dtype.kind == "f"), "a launcher's figure: non-finite")
        figures.append([a.shape for a in arrs])

    walls = {}
    with tempfile.TemporaryDirectory(prefix="tamf_debug_") as tmp, ExitStack() as stack:
        if not drawn:
            for mod, name in ((debug_refine, "render_sequence_grid"), (debug_sample, "render_sequence_grid"),
                              (viz_seg, "render_sequence_grid")):
                stack.enter_context(mock.patch.object(mod, name, record))
            stack.enter_context(mock.patch.object(debug_refine, "_overlay", lambda figs, path: None))
            stack.enter_context(mock.patch.object(debug_refine, "render_h2o_strip",
                                                  lambda h2o, path: record(*h2o.values())))
        out = os.path.join(tmp, "refine")
        _zero_counts(kernels)
        t0 = time.perf_counter()
        res = debug_refine.main(["--cfg", cfg("arch_refine.yml"), "--data.synthetic", "true",
                                 "--data.synthetic_size", str(DEBUG_SEGMENTS), "--data.n_obj_points", "8192",
                                 "--n_samples", str(DEBUG_SEGMENTS), "--html", "true", "--out", out])
        walls["debug_refine"] = time.perf_counter() - t0
        counts = {n: k.launches for n, k in kernels.items() if k.launches}
        require(counts.get("h2o_cull", 0) >= 1, f"debug_refine: #2 did not launch: {counts}")
        require(res["refine_h2o_dist"].shape == (DEBUG_SEGMENTS, 160, 778) and np.isfinite(res["refine_h2o_dist"]).all(),
                "debug_refine: refined h2o")
        want = {f"refine_{i:03d}{e}" for i in range(DEBUG_SEGMENTS) for e in (".html",) + (("_h2o.png", "_overlay.png") if drawn
                                                                                else ())}
        require(set(os.listdir(out)) == want, f"debug_refine: files {sorted(os.listdir(out))[:4]}...")

        out = os.path.join(tmp, "sample")
        t0 = time.perf_counter()
        pred = debug_sample.main(["--cfg", cfg("arch_mdm_l.yml"), "--data.synthetic", "true", "--html", "true",
                                  "--out", out])
        walls["debug_sample"] = time.perf_counter() - t0
        require(tuple(pred.shape) == (2, 160, 99) and bool(pred.isfinite().all()), "debug_sample: the sample")
        want = {f"sample_{i:03d}.{e}" for i in range(2) for e in ("html",) + (("png",) if drawn else ())}
        require(set(os.listdir(out)) == want, f"debug_sample: files {sorted(os.listdir(out))}")

        out = os.path.join(tmp, "viz")
        t0 = time.perf_counter()
        got = viz_seg.main(["--cfg", cfg("synthetic_smoke.yml"), "--indices", "0,1", "--html", "true", "--out", out])
        walls["viz_seg"] = time.perf_counter() - t0
        want = {f"seg_{i:04d}.{e}" for i in range(2) for e in ("html",) + (("png",) if drawn else ())}
        require(len(got) == 2 and set(os.listdir(out)) == want, f"viz_seg: files {sorted(os.listdir(out))}")

        pkl = os.path.join(tmp, "cache", "cache_dict.pkl")
        t0 = time.perf_counter()
        n = save_cache_dict.main(["--cfg", cfg("synthetic_smoke.yml"), "--out", pkl, "--commit"])
        walls["save_cache_dict"] = time.perf_counter() - t0
        require(n == 16 and os.path.exists(pkl), "save_cache_dict: the pickle")
    how = "PNGs drawn" if drawn else f"matplotlib absent: {len(figures)} figures' arrays recorded, not drawn"
    print("debug and data launchers on the card (wall s): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
          + f"; HTML viewers written, {how}; debug_refine's launches {counts} ({card_line()})", flush=True)
    return dict(walls=walls, debug_refine_launches=counts, png_drawn=drawn)


# ---------------------------------------------------------------------------
# The JAX package's checkpoint format (runtime/ckpt: .ckpt beside .pt)
# ---------------------------------------------------------------------------

CKPT_PHASE_KERNELS = ("h2o_nn", "h2o_cull", "h2o_nn_dvec", "nn_signed", "dist_loss")  # #1, #2, #4, #6, #8


def _state_tensors(state):
    """(name, parameter, exp_avg, exp_avg_sq) of each trainable parameter."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p in state.optimizer.params:
        st = state.optimizer.adamw.state[p]
        yield names[id(p)], p.detach(), st["exp_avg"], st["exp_avg_sq"]


def _split_key_bias(name: str, x):
    """(the part of `x` a train step resolves, attention's key-bias block
    or None): in_proj_bias is [q; k; v], and softmax ignores a key bias,
    so its true gradient is 0 and a step's rounding noise decides its
    AdamW move."""
    import torch

    if not name.endswith("in_proj_bias"):
        return x, None
    q, k, v = x.chunk(3)
    return torch.cat([q, v]), k


def _resume_through_both_formats(label: str, a, fresh, do_step, tmp: str):
    """State `a` (one step taken) saved as .pt (save_train_state) and as
    .ckpt (save_checkpoint); fresh states B (from the .pt) and C (from the
    .ckpt) must equal A bit for bit (parameters, AdamW moments and step,
    lr, schedule count). Then A, B and C take one more step through
    `do_step`: C must equal B within 1e-6 of each tensor's norm (parameters
    and both moments) plus 4 times the worst share of a norm by which A and
    B part, two resumes that no .ckpt touched: G's step is not bitwise
    reproducible on the card, R's is (0 there). Attention's key-bias block
    is held apart from that by AdamW's largest move (_split_key_bias). ->
    (the .ckpt's and the .pt's sizes and write seconds, the .ckpt's read +
    convert + load seconds, the load's device and host peaks, the
    differences; (the .pt's path, the .ckpt's))."""
    import tracemalloc

    import torch

    from oakink2_tamf_tpu_torch.runtime.ckpt import load_checkpoint, save_checkpoint, save_train_state

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt = save_train_state(tmp, 0, a, prefix=label)
    pt_write = time.perf_counter() - t0
    ck = os.path.join(tmp, f"{label}_0000.ckpt")
    t0 = time.perf_counter()
    save_checkpoint(ck, a)
    ck_write = time.perf_counter() - t0
    b = fresh()
    load_checkpoint(pt, b, strict=True)
    c = fresh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    load_checkpoint(ck, c, strict=True)
    torch.cuda.synchronize()
    ck_read = time.perf_counter() - t0
    dev_peak = (torch.cuda.max_memory_allocated() - before) / 2**20
    d = fresh()  # the same load again under tracemalloc (numpy's buffers are traced), untimed
    tracemalloc.start()
    load_checkpoint(ck, d, strict=True)
    host_peak = tracemalloc.get_traced_memory()[1] / 2**20
    tracemalloc.stop()
    del d
    for x, y in ((a, b), (b, c)):
        for (n, *xs), (_, *ys) in zip(_state_tensors(x), _state_tensors(y)):
            require(all(torch.equal(u, w) for u, w in zip(xs, ys)), f"{label}: {n} not bit-equal after the load")
        ox, oy = x.optimizer, y.optimizer
        require(x.step == y.step and ox.lr == oy.lr and ox.scheduler.last_epoch == oy.scheduler.last_epoch
                and {float(s["step"]) for s in ox.adamw.state.values()}
                == {float(s["step"]) for s in oy.adamw.state.values()},
                f"{label}: step {y.step} lr {oy.lr} after the load, {x.step} {ox.lr} before")

    for s in (a, b, c):
        do_step(s)
    torch.cuda.synchronize()
    lr = b.optimizer.adamw.param_groups[0]["lr"]
    gaps = {"C vs B": [0.0, 0.0, 0.0], "A vs B": [0.0, 0.0, 0.0]}  # largest abs, worst share of a norm, key bias
    rows = []  # (tensor, C vs B gap, its norm)
    for (n, *bs), (_, *cs), (_, *as_) in zip(_state_tensors(b), _state_tensors(c), _state_tensors(a)):
        for i, xs in enumerate(zip(bs, cs, as_)):
            (rb, kb), (rc, kc), (ra, ka) = (_split_key_bias(n, x) for x in xs)
            norm = rb.norm().item()
            for pair, ro, ko in (("C vs B", rc, kc), ("A vs B", ra, ka)):
                g = gaps[pair]
                g[0] = max(g[0], (rb - ro).abs().max().item())
                g[1] = max(g[1], (rb - ro).norm().item() / norm if norm else 0.0)
                if kb is not None and i == 0:
                    g[2] = max(g[2], (kb - ko).abs().max().item())
            rows.append((f"{n}{('', ' exp_avg', ' exp_avg_sq')[i]}", (rb - rc).norm().item(), norm))
    # the step's own reproducibility: A vs B's worst share of a norm, two
    # resumes that no .ckpt touched (0 where the step is bitwise reproducible)
    share = 1e-6 + 4 * gaps["A vs B"][1]
    for name, gap, norm in rows:
        require(gap <= share * norm, f"{label} resumed from .ckpt vs .pt: {name} differs by {gap} (norm {norm}, "
                                     f"allowed {share:.3g} of it)")
    # AdamW's move at its second step is at most 1.0014 lr (Cauchy-Schwarz over
    # betas 0.9, 0.999 and their bias corrections), so two runs part by 2.0028 lr
    require(gaps["C vs B"][2] <= 2.0028 * lr, f"{label}: the key bias moved {gaps['C vs B'][2]} apart (lr {lr})")
    oa, oc = a.optimizer, c.optimizer
    require(c.step == a.step and oc.lr == oa.lr and oc.scheduler.last_epoch == oa.scheduler.last_epoch,
            f"{label}: resumed from .ckpt at step {c.step} lr {oc.lr}, A at step {a.step} lr {oa.lr}")
    out = dict(ckpt_mb=os.path.getsize(ck) / 2**20, pt_mb=os.path.getsize(pt) / 2**20, ckpt_write_s=ck_write,
               pt_write_s=pt_write, ckpt_read_convert_s=ck_read, load_device_peak_mib=dev_peak,
               load_host_peak_mib=host_peak, step=c.step, lr=oc.lr,
               **{f"{k} {w}": v for k, g in gaps.items() for w, v in zip(("max_abs", "worst_norm_share",
                                                                          "key_bias_max_abs"), g)})
    print(f"{label}: B (from .pt) and C (from .ckpt) bit-equal to A after the load; after one more step C vs B "
          f"largest difference {gaps['C vs B'][0]:.3g} (worst {gaps['C vs B'][1]:.3g} of a tensor's norm), A vs "
          f"B {gaps['A vs B'][0]:.3g} ({gaps['A vs B'][1]:.3g}), outside attention's key bias, which moved "
          f"{gaps['C vs B'][2]:.3g} / {gaps['A vs B'][2]:.3g} apart (lr {lr}); step {c.step}, lr {oc.lr} as A's; "
          f".ckpt {out['ckpt_mb']:.2f} MiB written in {ck_write:.3f} s (.pt {out['pt_mb']:.2f} MiB in "
          f"{pt_write:.3f} s), read + convert + load {ck_read:.3f} s, load peaks {dev_peak:.1f} MiB on the card "
          f"and {host_peak:.1f} MiB of host arrays", flush=True)
    return out, (pt, ck)


def jax_ckpt_path(dev: str = "cuda") -> tuple[dict, dict]:
    """The JAX package's checkpoint format on the card: G at arch_mdm_l on
    the fused route (batch 64 x 160 frames x 4 objects x 8192 points, t and
    noise fixed) and R at arch_refine on the all-pairs route (2048 points)
    each resumed from a .ckpt that runtime/ckpt.save_checkpoint wrote and
    from the .pt of the same state (_resume_through_both_formats); then
    serving.TamfPipeline.load from the two .ckpt files and from the two .pt
    files, one generate of 16 segments each on the cull route at 8192
    points with 50 respaced steps from one seed: outputs within 1e-6. The
    counts of #1, #2, #4, #6 and #8 are set to 0 at the start and read at
    the end. -> (those counts, stats). `dev` other than "cuda" only
    rehearses the control flow (with torch.cuda's calls stubbed)."""
    import tempfile

    import numpy as np
    import torch

    from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments
    from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
    from oakink2_tamf_tpu_torch.models.mdm_g import InteractionSegmentMDM, MDMConfig
    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig, SegmentRefineNet
    from oakink2_tamf_tpu_torch.parallel import train as PT
    from oakink2_tamf_tpu_torch.serving import TamfPipeline

    dev = torch.device(dev)
    kernels = _all_kernels()
    _zero_counts(kernels)
    stats, files = {"card": card_line()}, {}

    def fresh(build):
        def make():
            torch.manual_seed(1)  # other weights than A's: the load must overwrite them
            m = build().to(dev)
            return PT.TrainState(m, PT.make_optimizer(m.named_parameters()))
        return make

    with tempfile.TemporaryDirectory(prefix="tamf_jax_ckpt_") as tmp:
        clip = FrozenClipText(device=dev)
        db = _train_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, TRAIN_P, seed=11, clip=clip, device=dev)
        del clip
        gen = torch.Generator(device=dev).manual_seed(3)
        db.update(t=torch.randint(0, 1000, (TRAIN_BS,), device=dev, generator=gen),
                  t_weights=torch.ones(TRAIN_BS, device=dev))
        noise = torch.randn(db["pose_repr"].shape, device=dev, generator=gen)
        a, g_step, _ = _g_training(dev, MDMConfig.arch_mdm_l(), "auto")

        def g_once(s):
            torch.manual_seed(5)  # dropout and the cond mask
            g_step(s, db, noise=noise)

        g_once(a)
        stats["g"], files["g"] = _resume_through_both_formats(
            "G", a, fresh(lambda: InteractionSegmentMDM(MDMConfig.arch_mdm_l())), g_once, tmp)
        del a, db, noise
        torch.cuda.empty_cache()

        a, r_step, mano, _ = _r_training(dev, RefineConfig(), "auto")
        db, _ = _r_batch(TRAIN_BS, TRAIN_L, TRAIN_NOBJ, R_ALL_PAIRS_P, 11, mano, dev)

        def r_once(s):
            torch.manual_seed(5)  # dropout
            r_step(s, db)

        r_once(a)
        stats["r"], files["r"] = _resume_through_both_formats(
            "R", a, fresh(lambda: SegmentRefineNet(RefineConfig())), r_once, tmp)
        del a, db
        torch.cuda.empty_cache()

        ds = SyntheticSegments(16, seq_len=160, max_nobj=4, n_obj_points=TRAIN_P, seed=11)
        segs = [ds[i] for i in range(16)]
        outs, walls = {}, {}
        for fmt, i in (("pt", 0), ("ckpt", 1)):
            t0 = time.perf_counter()
            pipe = TamfPipeline.load(files["g"][i], files["r"][i], device=dev, diffusion_steps=1000,
                                     timestep_respacing="50", batch_size=16, seq_len=160, max_nobj=4,
                                     n_obj_points=TRAIN_P)
            outs[fmt] = pipe.generate(segs, generator=torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            walls[fmt] = time.perf_counter() - t0
            del pipe
    gap = max(float(np.abs(x[k] - y[k]).max()) for x, y in zip(outs["pt"], outs["ckpt"]) for k in x)
    require(len(outs["ckpt"]) == 16 and all(np.isfinite(v).all() for r in outs["ckpt"] for v in r.values()),
            "serving from .ckpt: non-finite or missing output")
    require(gap <= 1e-6, f"serving from .ckpt vs from .pt: outputs differ by {gap}")
    counts = {n: kernels[n].launches for n in CKPT_PHASE_KERNELS}
    for n in CKPT_PHASE_KERNELS:
        require(counts[n] > 0, f"the .ckpt phase never launched {n}: {counts}")
    stats["serving"] = dict(max_abs_diff=gap, load_generate_s=walls)
    print(f"serving (cull route, 8192 points, 50 respaced steps) from the .ckpt files vs the .pt files: largest "
          f"difference {gap:.3g}; load + generate(16) {walls['ckpt']:.2f} s / {walls['pt']:.2f} s; the phase's "
          f"launches {counts} ({stats['card']})", flush=True)
    return counts, stats


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
               NN.DVEC_KERNEL, CU.DVEC_KERNEL, HB.KERNEL, *CC.KERNELS, CL.CULL_KERNEL, CU.MASK_KERNEL]
    t0 = time.perf_counter()
    _build.build_all(kernels)
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for k in kernels:
        print("\n".join(ln for ln in k.ptxas_log.splitlines() if "Used" in ln or "spill" in ln))
    sass = {}
    for k in (CS.KERNEL, CL.KERNEL, CL.CULL_KERNEL, CC.H2O_KERNEL, CU.KERNEL, CU.DVEC_KERNEL, NN.KERNEL,
              NN.DVEC_KERNEL, CC.O2H_KERNEL, CU.MASK_KERNEL):  # the pair searches' hot loop
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
    phase("h2o cull mask kernel")
    kstats.update(check_mask_kernel())
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
    phase("small train-option parity (bf16, remat)")
    small_option_parity()
    phase("training main path (fused)")
    state, db, train_counts, _ = train_main_path()
    phase("training main path (fused_cull)")
    state, db, fc_counts, _ = train_main_path("fused_cull", state, db)
    phase("composed route")
    composed_counts = composed_route(state, db)
    del state
    torch.cuda.empty_cache()
    phase("G training options at full width (bf16, remat)")
    g_option_main_path(db)
    del db
    torch.cuda.empty_cache()
    phase("entry point")
    entry_point()
    phase("entry point, fused_cull")
    entry_point("fused_cull")
    phase("gt_geom cache")
    gt_cache_path()
    phase("train_g profiler trace")
    profile_entry_point()
    phase("R training main path (cull route)")
    CU.MASK_KERNEL.launches = 0
    _, r_counts, _ = r_train_main_path()
    mask_counts = {"r_train": CU.MASK_KERNEL.launches}
    torch.cuda.empty_cache()
    phase("R training main path (all-pairs route)")
    _, r_ap_counts, r_ap_step_s = r_train_main_path("all-pairs")
    torch.cuda.empty_cache()
    phase("R training at bf16, all-pairs route")
    r_option_main_path()
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
    CU.MASK_KERNEL.launches = 0
    cull_counts, _ = main_path(8192, "", "h2o_cull", "main path (cull route, 8192 points)")
    mask_counts["serving"] = CU.MASK_KERNEL.launches
    require(min(mask_counts.values()) > 0, f"the mask kernel did not launch on a cull route: {mask_counts}")
    print(f"h2o_cull_mask launches: {mask_counts} (R train main path, serving main path)", flush=True)
    phase("serving main path, all-pairs route")
    nn_counts, _ = main_path(2048, "50", "h2o_nn", "main path (all-pairs route, 2048 points)")
    phase("small sampler parity")
    small_sampler_parity()
    phase("diffusion vb branches, GPU vs CPU")
    vb_branch_parity()
    phase("samplers and the G->R chain at full width")
    chain_cull, sample_stats = sampler_main_path()
    phase("sample_g, sample_r and compute_score entry points")
    launcher_nn, chain_score_nn = sample_entry_points()
    print("sampling: " + json.dumps(sample_stats), flush=True)
    phase("scoring chain: real-format data, train_encoder, compute_score")
    score_nn, score_stats = scoring_path()
    print("scoring: " + json.dumps(score_stats), flush=True)
    phase("process group, one rank (NCCL)")
    one_rank = group_one_rank()
    print("process group: " + json.dumps({"card": card_line(), **{
        k: {n: v for n, v in o.items() if n != "grads"} for k, o in one_rank.items()}}), flush=True)
    phase("two ranks sharing the card (gloo)")
    group_two_ranks(one_rank)
    del one_rank
    phase("train_r.main on two ranks")
    train_r_two_ranks()
    phase("PointBERT tower at full width")
    pb_stats = pointbert_path()
    print("pointbert: " + json.dumps(pb_stats), flush=True)
    phase("compute_obj_assets entry point")
    obj_assets_entry_point()
    phase("xla route, vertex normals, MANO per side, R at h2o_backend xla, debug and data launchers")
    xla_stats = {"route": xla_route(), "normals_mano": normals_and_mano_sides(),
                 "r_step": r_xla_main_path(r_ap_step_s), "launchers": debug_launchers()}
    print("xla: " + json.dumps(xla_stats), flush=True)
    phase("the JAX package's checkpoint format: G and R resumed from .ckpt and .pt, serving from both")
    ckpt_counts, ckpt_stats = jax_ckpt_path()
    print("jax_ckpt: " + json.dumps(ckpt_stats), flush=True)
    # each kernel's count from the paths that run it: serving for #1/#2 (#1
    # also in sample_r and in compute_score's CR on its output and on the
    # real-format data, #2 also in the full-width G->R chain), the fused G
    # training path for #6/#8, its fused_cull route for #9, the
    # composed route for #7, the R training paths for #3 (cull) and #4
    # (all-pairs), the grad_y path for #5, the R cluster route for #10/#11,
    # the signed cluster entry point for #12/#13; the .ckpt phase for #1, #2,
    # #4, #6 and #8
    launches = {"h2o_nn": nn_counts["h2o_nn"] + launcher_nn + chain_score_nn + score_nn + ckpt_counts["h2o_nn"],
                "h2o_cull": cull_counts["h2o_cull"] + chain_cull + ckpt_counts["h2o_cull"],
                "h2o_cull_mask": mask_counts["r_train"] + mask_counts["serving"],
                "nn_signed": train_counts["nn_signed"] + ckpt_counts["nn_signed"],
                "dist_loss": train_counts["dist_loss"] + ckpt_counts["dist_loss"],
                "dist_loss_cull": fc_counts["dist_loss_cull"],
                "nn_signed_bwd": composed_counts["nn_signed_bwd"],
                "h2o_cull_dvec": r_counts["h2o_cull_dvec"],
                "h2o_nn_dvec": r_ap_counts["h2o_nn_dvec"] + ckpt_counts["h2o_nn_dvec"],
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
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in ("--two-rank-worker", "--train-r-worker"):
        # a rank of the process-group phases, started by _spawn_ranks
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from oakink2_tamf_tpu_torch._device import set_fp32_precision

        set_fp32_precision()
        if sys.argv[1] == "--two-rank-worker":
            _two_rank_worker(sys.argv[2], int(sys.argv[3]))
        else:
            _train_r_worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
