#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (oakink2_tamf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
1. build the CUDA kernels from ops/csrc (one nvcc per source, in parallel);
2. check each kernel against its plain PyTorch version on the card at the
   main path's shapes (10240 frames = 64 clouds x 160 frames, 778 hand
   rows, 2048 / 8192 object points) with ragged y_valid, one all-invalid
   cloud and x_valid=False frames; check that the two kernels' values are
   bit-identical on valid frames; time kernel, plain version and
   torch.cdist(...).amin(-1) as the library yardstick;
3. a small pipeline on the GPU and on the CPU with the same weights and
   noise: outputs must agree;
4. the main path, cull route: TamfPipeline at arch_mdm_l G, default R,
   synthetic MANO, random-init CLIP with the hash tokenizer, 1000 DDPM
   steps, batch 16 x 160 frames x 4 objects x 8192 points; one generate of
   16 segments; the culled kernel must have launched;
5. the all-pairs route: the same at 2048 points with 50 respaced steps; the
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from oakink2_tamf_tpu_torch._device import set_fp32_precision
    from oakink2_tamf_tpu_torch.ops import _build
    from oakink2_tamf_tpu_torch.ops import chamfer_cull as CU
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    set_fp32_precision()
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.build_all([NN.KERNEL, CU.KERNEL])
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for k in (NN.KERNEL, CU.KERNEL):
        print("\n".join(ln for ln in k.ptxas_log.splitlines() if "Used" in ln or "spill" in ln))

    kstats = check_kernels()
    small_parity()
    cull_counts, _ = main_path(8192, "", "h2o_cull", "main path (cull route, 8192 points)")
    nn_counts, _ = main_path(2048, "50", "h2o_nn", "main path (all-pairs route, 2048 points)")
    launches = {"h2o_nn": nn_counts["h2o_nn"], "h2o_cull": cull_counts["h2o_cull"]}

    line = {"kernels": []}
    for name, s in kstats.items():
        k = s["kernel"]
        line["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": f"oakink2_tamf_tpu_torch/ops/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": launches[name],
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"],
            "library_ms": s["library_ms"],
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
