#!/usr/bin/env python3
"""Time layout variants of the h2o cell search (h2o_cells_common.cuh) on one
GPU: kernel #10 (h2o_topk.cu), or with --all-pairs kernels #4
(h2o_nn_dvec.cu) and #1 (h2o_nn.cu).

    python3 topk_variants.py [--all-pairs] [--parent [LABEL=]DIR ...] [RPTxSPLITxSEG@BLOCKS ...]

Each variant is the kernel's source built with CELLS_RPT (rows per thread),
CELLS_SPLIT (sets of warps that split the cell list), CELLS_SEG (points per
segment whose minimum carries the rank) and CELLS_MIN_BLOCKS
(__launch_bounds__' blocks per SM) set by -D flags, into the git-ignored
ops/_build/variants/ (default: the ones compared in PERF.md, the shipped
4x4x32@8 among them). For each it prints ptxas' registers and spills and
the SASS hot loop's instructions per pair (chip_smoke.sass_inner_loop),
checks it equal to the shipped build and times it in turns: shipped, each
variant, each variant again in reverse order, shipped. "noskip" is the
shipped build with every cell flagged as holding a valid point (what the
empty cells cost). Each --parent DIR (repeatable) builds the kernel of
another csrc directory (e.g. an earlier commit's, unpacked with git
archive; its launch may take the cell flags or not), and checks and times
it in the same turns, as LABEL ("parent" by default).

Shapes: #10 at the R training shape (chip_smoke.cluster_operands: 40960
frames x 778 rows x 8192 points, y_group 160, the selection's K = 24 cells
per tile); #4 at chip_smoke's R check shape (40960 frames x 778 x 2048,
y_group 160, one of the 256 clouds all-invalid, one ragged) and #1 at its
serving shape (10240 frames x 778 x 2048), both from
chip_smoke.kernel_inputs.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

DEFAULT = ("4x4x128@8", "4x4x64@8", "4x4x32@12", "4x2x32@8", "4x8x32@4", "2x4x32@4", "1x4x32@2")
# one warp set (each warp walks every listed cell for its rows, no
# cross-set merge) beside the shipped 4 sets
DEFAULT_ALL_PAIRS = ("4x1x32@32", "4x1x32@16", "4x2x32@16", "2x1x32@16", "4x1x64@32")


class Target:
    """One kernel under test: its source, launch symbol and operands. `call`
    maps (fn, flags pointer or None, outputs) to the launch's return code."""

    def __init__(self, kernel, label: str, operands, call):
        self.kernel = kernel
        self.label = label
        self.operands = operands  # () -> (outputs, flags, description), made when timed
        self.call = call


def cluster_target(S, CC, torch):
    state = {}

    def operands():
        L = S.TRAIN_L
        x, y, yv, perm, _ = S.cluster_operands(seed=13)
        _, xs, y4, ctr = CC._prepare(x, y, yv, L, perm)
        cidx, _ = CC.h2o_candidates(x, y, yv, x_perm=perm, y_group=L)
        del x, y, yv
        F, P1, _ = xs.shape
        T, K = cidx.shape[1:]
        live = CC.cell_flags(y4)
        state.update(xs=xs, y4=y4, ctr=ctr, cidx=cidx, L=L, T=T, K=K)
        outs = (torch.empty((F, P1), device="cuda"), torch.empty((F, P1), dtype=torch.int32, device="cuda"))
        return outs, live, f"F={F} P1={P1} P2={y4.shape[1]} y_group={L} K={K}"

    def call(fn, flags, outs):
        s = state
        F, P1, _ = s["xs"].shape
        return fn(s["xs"].data_ptr(), s["y4"].data_ptr(), s["ctr"].data_ptr(), s["cidx"].data_ptr(),
                  *(() if flags is None else (flags.data_ptr(),)), outs[0].data_ptr(), outs[1].data_ptr(),
                  F, P1, s["y4"].shape[1], s["L"], s["T"], s["K"], torch.cuda.current_stream().cuda_stream)

    return Target(CC.H2O_KERNEL, "h2o_topk", operands, call)


def all_pairs_target(S, NN, torch, kernel, G: int, seed: int):
    state = {}

    def operands():
        L = S.TRAIN_L
        x, y, yv, _, _ = S.kernel_inputs(2048, G=G, L=L, seed=seed)
        xs, y4, ctr = NN.prepare(x, y, yv, L)
        del x, y, yv
        F, P1, _ = xs.shape
        state.update(xs=xs, y4=y4, ctr=ctr, L=L)
        second = (torch.empty((F, P1, 3), device="cuda") if kernel is NN.DVEC_KERNEL
                  else torch.empty((F, P1), dtype=torch.int32, device="cuda"))
        return (torch.empty((F, P1), device="cuda"), second), NN.cell_flags(y4), \
            f"F={F} P1={P1} P2={y4.shape[1]} y_group={L}"

    def call(fn, flags, outs):
        s = state
        F, P1, _ = s["xs"].shape
        return fn(s["xs"].data_ptr(), s["y4"].data_ptr(), s["ctr"].data_ptr(),
                  *(() if flags is None else (flags.data_ptr(),)), outs[0].data_ptr(), outs[1].data_ptr(),
                  F, P1, s["y4"].shape[1], s["L"], torch.cuda.current_stream().cuda_stream)

    return Target(kernel, kernel.name, operands, call)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_variants: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as S
    from oakink2_tamf_tpu_torch._device import set_fp32_precision
    from oakink2_tamf_tpu_torch.ops import _build
    from oakink2_tamf_tpu_torch.ops import chamfer_cluster as CC
    from oakink2_tamf_tpu_torch.ops import chamfer_nn as NN

    set_fp32_precision()
    all_pairs = argv[:1] == ["--all-pairs"]
    argv = argv[1:] if all_pairs else argv
    parents = {}
    while argv[:1] == ["--parent"]:
        label, _, d = argv[1].rpartition("=")
        parents[label or "parent"] = os.path.abspath(d)
        argv = argv[2:]
    names = argv or list(DEFAULT_ALL_PAIRS if all_pairs else DEFAULT)
    if all_pairs:  # #4 at the R check shape (256 clouds), #1 at the serving shape (64)
        targets = [all_pairs_target(S, NN, torch, NN.DVEC_KERNEL, 256, 5),
                   all_pairs_target(S, NN, torch, NN.KERNEL, 64, 0)]
    else:
        targets = [cluster_target(S, CC, torch)]
    _build.build_all([t.kernel for t in targets])
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

    # every build of every target started at once
    jobs = {}  # (target label, variant) -> (process, so, flagged)
    for t in targets:
        src = os.path.join(_build.CSRC, t.kernel.source)
        for name in names:
            rpt, split, seg, blocks = (int(v) for v in re.fullmatch(r"(\d+)x(\d+)x(\d+)@(\d+)", name).groups())
            so = os.path.join(out_dir, f"{t.label}-{name}.so")
            flags = [f"-DCELLS_RPT={rpt}", f"-DCELLS_SPLIT={split}", f"-DCELLS_SEG={seg}",
                     f"-DCELLS_MIN_BLOCKS={blocks}"]
            jobs[t.label, name] = (nvcc(src, so, flags), so, True)
        for label, d in parents.items():
            so = os.path.join(out_dir, f"{t.label}-{label}.so")
            psrc = os.path.join(d, t.kernel.source)
            # does that build's launch take the cell flags
            flagged = "live" in open(psrc).read().split(t.kernel.symbol, 1)[1].split(")", 1)[0]
            jobs[t.label, label] = (nvcc(psrc, so, []), so, flagged)

    for t in targets:
        fns = {"shipped": (getattr(t.kernel.lib(), t.kernel.symbol), True)}
        logs = {"shipped": (t.kernel.ptxas_log, t.kernel._paths()[1])}
        for (lab, name), (proc, so, flagged) in jobs.items():
            if lab != t.label:
                continue
            out, _ = proc.communicate()
            if proc.returncode:
                print(out, file=sys.stderr)
                return 1
            fn = getattr(ctypes.CDLL(so), t.kernel.symbol)
            # the pointers (less the flags where the build takes none), the ints, the stream
            n_ptr = t.kernel.argtypes.count(ctypes.c_void_p) - 1 - (0 if flagged else 1)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * t.kernel.argtypes.count(ctypes.c_int)
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[name] = (fn, flagged)
            logs[name] = (out, so)
        for name, (log, so) in logs.items():
            regs = "; ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln)
            st = S.sass_inner_loop(Built(so))
            print(f"{name} {t.label}: {regs}; SASS hot loop {st['instructions']} instructions per {st['pairs']} "
                  f"pairs = {st['instructions'] / max(st['pairs'], 1):.3f} per pair", flush=True)

        outs, live, desc = t.operands()
        ones = torch.ones_like(live)

        def run(name):
            fn, flagged = fns["shipped" if name == "noskip" else name]
            flags = (ones if name == "noskip" else live) if flagged else None
            rc = t.call(fn, flags, outs)
            S.require(rc == 0, f"{name}: {t.label} launch failed ({rc})")

        run("shipped")
        ref = tuple(o.clone() for o in outs)
        timed = ["noskip"] + [n for n in fns if n != "shipped"]
        for name in timed:
            run(name)
            S.require(all(torch.equal(a, b) for a, b in zip(outs, ref)),
                      f"{name}: {t.label} differs from the shipped build")
        print(f"{t.label} {desc}: every variant equal to the shipped build; cells with a valid point "
              f"{int(live.sum())} of {live.numel()}", flush=True)
        for name in ["shipped"] + timed + timed[::-1] + ["shipped"]:
            print(f"{name}: {t.label} {S.cuda_time_ms(lambda: run(name), reps=5):.3f} ms", flush=True)
        del outs, live, ones, ref
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
