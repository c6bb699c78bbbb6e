#!/usr/bin/env python3
"""Time variants of the o2h scatter (ops/csrc/o2h_scatter_common.cuh) on one
GPU: kernel #7 (nn_signed_bwd.cu) at the G training shape and kernel #13
(o2h_topk_bwd.cu) at the R training shape, both without grad_y as their
callers run them.

    python3 scatter_variants.py [--parent [LABEL=]DIR ...] [--composed] [cCuUtT ...]

Each variant is the kernel's source built with O2H_CARRY=C (1: the warp
carries a row across steps in registers, 0: every row goes to the segmented
tree), O2H_UNROLL=U (steps whose operands are loaded together) and
O2H_THREADS=T (threads per block) set by -D flags, into the git-ignored
ops/_build/variants/ (default: the ones compared in PERF.md besides the
shipped c1u4t256). For each it prints ptxas' registers and spills and the scatter loop's SASS instructions per point
(chip_smoke.scatter_sass), holds its gx to the shipped build's per frame
within 1e-6 of the terms' magnitudes (chip_smoke.scatter_mass_close) and
times it in turns: shipped, each variant, each variant again in reverse
order, shipped. Each --parent DIR (repeatable) builds the kernel of another
csrc directory (e.g. an earlier commit's, unpacked with git archive), and
checks and times it in the same turns, as LABEL ("parent" by default).
--composed adds #7 on the operands of a composed G step at full width
(chip_smoke.composed_bwd_operands: arch_mdm_l, the G main path's batch).

Shapes: #7 on chip_smoke.training_scene (40960 frames x 778 rows x 8192
points, y_group 160) with the signed forward's argmins and random
cotangents, as chip_smoke times it; #13 on chip_smoke.cluster_operands (the
R main path's sample hands, per-frame clouds, 37.5% of the object slots
padded) with the exact o2h forward's argmins, as chip_smoke times it.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

DEFAULT = ("c0u4t256", "c1u2t256", "c1u1t256", "c1u4t128", "c1u4t512")


class Target:
    """One kernel under test: `operands()` makes (args before gx, gx, args
    after gx, the terms' magnitudes, description) when it is timed."""

    def __init__(self, kernel, operands):
        self.kernel = kernel
        self.label = kernel.name
        self.operands = operands


def signed_bwd_target(S, CS, torch):
    def operands():
        L = S.TRAIN_L
        x, n, y, _, _, _, _, _ = S.training_scene(S.TRAIN_CLOUDS, L, seed=3)
        fwd = CS.launch(*CS.prepare(x, y, n, None, L), L)  # the loss passes no y_valid
        h2o_i, o2h_i = fwd[1], fwd[3]
        del fwd, n
        F, P1, _ = x.shape
        P2 = y.shape[1]
        xr = torch.randn(F, P1, device="cuda")
        yc = torch.randn(F, P2, device="cuda")
        mass = S.backward_exact(x[:F // 8], y[: S.TRAIN_CLOUDS // 8], o2h_i[:F // 8], yc[:F // 8],
                           h2o_i[:F // 8], xr[:F // 8], L)[0][1]
        before = (x, y, h2o_i, o2h_i, xr, yc)
        gx = torch.empty((F, P1, 3), device="cuda")
        after = (None, F, P1, P2, L, 0)
        rpw = S.rows_per_warp(o2h_i, yc)
        return before, gx, after, mass, f"F={F} P1={P1} P2={P2} y_group={L}, distinct rows per 32 live " \
            f"points {rpw:.4f}"

    return Target(CS.BWD_KERNEL, operands)


def composed_target(S, CS, torch):
    """#7 on the operands of a composed G step (chip_smoke.composed_bwd_operands)."""
    def operands():
        x, y, h2o_i, o2h_i, xr, yc, grad_y, L = S.composed_bwd_operands()
        F, P1, _ = x.shape
        P2 = y.shape[1]
        f8 = F // 8
        mass = S.backward_exact(x[:f8], y[: y.shape[0] // 8], o2h_i[:f8], yc[:f8], h2o_i[:f8], xr[:f8], L)[0][1]
        rpw = S.rows_per_warp(o2h_i, yc)
        return (x, y, h2o_i, o2h_i, xr, yc), torch.empty((F, P1, 3), device="cuda"), \
            (None, F, P1, P2, L, int(grad_y)), mass, \
            f"composed G step: F={F} P1={P1} P2={P2} y_group={L}, {int((yc != 0).sum())} live points, " \
            f"distinct rows per 32 live points {rpw:.4f}"

    t = Target(CS.BWD_KERNEL, operands)
    t.label = "nn_signed_bwd_composed"
    return t


def o2h_bwd_target(S, CC, torch):
    def operands():
        L = S.TRAIN_L
        x, y, yv, perm, nrm = S.cluster_operands(seed=13)
        yF, yvF = y.repeat_interleave(L, 0).contiguous(), yv.repeat_interleave(L, 0)
        xpF, xsF, y4F, ctrF = CC._prepare(x, yF, yvF, 1, perm)
        F, P1, _ = x.shape
        T = -(-P1 // CC.S_CELL)
        C = y4F.shape[1] // CC.S_CELL
        cidx_y = torch.arange(T, dtype=torch.int32, device="cuda").expand(F, C, T).contiguous()
        o2h = CC.launch_o2h_topk(xsF, xpF.apply(nrm).contiguous(), y4F, ctrF, cidx_y)
        o2h_i = xpF.to_original(torch.clamp(o2h[1], 0, P1 - 1)).to(torch.int32)
        del o2h, xsF, y4F, ctrF, cidx_y, nrm
        ycot = torch.randn(F, yF.shape[1], device="cuda") * yvF
        f8 = F // 8
        mass = S.o2h_mass(x[:f8], yF[:f8], o2h_i[:f8], ycot[:f8])
        gx = torch.empty((F, P1, 3), device="cuda")
        rpw = S.rows_per_warp(o2h_i, ycot)
        return (x, yF, o2h_i, ycot), gx, (None, F, P1, yF.shape[1], 0), mass, \
            f"F={F} P1={P1} P2={yF.shape[1]} per-frame clouds, {int(yvF.sum())} live points, distinct rows " \
            f"per 32 live points {rpw:.4f}"

    return Target(CC.O2H_BWD_KERNEL, operands)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("scatter_variants: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as S
    from oakink2_tamf_tpu_torch._device import set_fp32_precision
    from oakink2_tamf_tpu_torch.ops import _build
    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    set_fp32_precision()
    parents = {}
    while argv[:1] == ["--parent"]:
        label, _, d = argv[1].rpartition("=")
        parents[label or "parent"] = os.path.abspath(d)
        argv = argv[2:]
    composed = argv[:1] == ["--composed"]
    argv = argv[1:] if composed else argv
    names = argv or list(DEFAULT)
    targets = [signed_bwd_target(S, CS, torch), o2h_bwd_target(S, CC, torch)]
    if composed:
        targets.insert(1, composed_target(S, CS, torch))
    _build.build_all([CS.KERNEL, CC.O2H_KERNEL, CS.BWD_KERNEL, CC.O2H_BWD_KERNEL])
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)

    class Built:  # what sass_inner_loop reads of a kernel
        def __init__(self, so):
            self.so = so

        def _paths(self):
            return "", self.so

    def nvcc(src, so, flags):
        return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so, src],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    jobs = {}  # (kernel, variant) -> (process, so); every build started at once
    for k in {t.kernel.name: t.kernel for t in targets}.values():
        src = os.path.join(_build.CSRC, k.source)
        for name in names:
            c, u, th = re.fullmatch(r"c(\d)u(\d+)t(\d+)", name).groups()
            so = os.path.join(out_dir, f"{k.name}-{name}.so")
            jobs[k.name, name] = (nvcc(src, so, [f"-DO2H_CARRY={c}", f"-DO2H_UNROLL={u}", f"-DO2H_THREADS={th}"]),
                                  so)
        for label, d in parents.items():
            so = os.path.join(out_dir, f"{k.name}-{label}.so")
            jobs[k.name, label] = (nvcc(os.path.join(d, k.source), so, []), so)

    built = {}  # (kernel, variant) -> (ptxas log, so)
    for key, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(out, file=sys.stderr)
            return 1
        built[key] = (out, so)

    for t in targets:
        fns = {"shipped": getattr(t.kernel.lib(), t.kernel.symbol)}
        logs = {"shipped": (t.kernel.ptxas_log, t.kernel._paths()[1])}
        for (k, name), (out, so) in built.items():
            if k != t.kernel.name:
                continue
            fn = getattr(ctypes.CDLL(so), t.kernel.symbol)
            fn.argtypes, fn.restype = t.kernel.argtypes, ctypes.c_int
            fns[name] = fn
            logs[name] = (out, so)
        for name, (log, so) in logs.items() if t.label == t.kernel.name else ():
            regs = "; ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln)
            st = S.scatter_sass(Built(so))
            print(f"{name} {t.label}: {regs}; SASS scatter loop {st['instructions']} instructions per "
                  f"{st['pairs'] // 3} points = {st['per_point']:.3f} per point ({st['fast_per_point']:.3f} outside "
                  f"the atomics' blocks); {st['opcodes']}", flush=True)

        before, gx, after, mass, desc = t.operands()
        stream = torch.cuda.current_stream().cuda_stream

        def run(name):
            args = [a.data_ptr() for a in before] + [gx.data_ptr()] + list(after) + [stream]
            rc = fns[name](*args)
            S.require(rc == 0, f"{name}: {t.label} launch failed ({rc})")

        run("shipped")
        ref = gx.clone()
        f8 = mass.shape[0]
        timed = [n for n in fns if n != "shipped"]
        for name in timed:
            run(name)
            S.require(S.scatter_mass_close(gx[:f8], ref[:f8], mass),
                      f"{name}: {t.label} gx differs from the shipped build beyond 1e-6 of the magnitudes")
        print(f"{t.label} {desc}: every variant's gx within 1e-6 of the terms' magnitudes of the shipped "
              f"build's on the first {f8} frames", flush=True)
        for name in ["shipped"] + timed + timed[::-1] + ["shipped"]:
            print(f"{name}: {t.label} {S.cuda_time_ms(lambda: run(name), reps=10):.3f} ms", flush=True)
        del before, gx, after, mass, ref
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
