#!/usr/bin/env python3
"""Time variants of kernel #10's cell search (h2o_topk.cu on
h2o_cells_common.cuh) on one GPU.

    python3 topk_variants.py [--parent [LABEL=]DIR ...] [RPTxSPLITxSEG@BLOCKS ...]

Each variant is h2o_topk.cu built with CELLS_RPT (rows per thread),
CELLS_SPLIT (sets of warps that split a tile's candidate list), CELLS_SEG
(points per segment whose minimum carries the rank) and CELLS_MIN_BLOCKS
(__launch_bounds__' blocks per SM) set by -D flags, into the git-ignored
ops/_build/variants/ (default: the ones compared in PERF.md, the shipped
4x4x32@8 among them). For each it prints ptxas' registers and spills and
the SASS hot loop's instructions per pair (chip_smoke.sass_inner_loop),
checks it equal to the shipped build at the R training shape
(chip_smoke.cluster_operands: 40960 frames x 778 rows x 8192 points,
y_group 160, the selection's K = 24 cells per tile), and times it there in
turns: shipped, each variant, each variant again in reverse order,
shipped. "noskip" is the shipped build with every cell flagged as holding
a valid point (what the empty cells cost). Each --parent DIR (repeatable)
builds DIR/h2o_topk.cu, the kernel of another csrc directory (e.g. an
earlier commit's, unpacked with git archive; its launch may take the cell
flags or not), and checks and times it in the same turns, as LABEL
("parent" by default).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

DEFAULT = ("4x4x128@8", "4x4x64@8", "4x4x32@12", "4x2x32@8", "4x8x32@4", "2x4x32@4", "1x4x32@2")


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

    set_fp32_precision()
    parents = {}
    while argv[:1] == ["--parent"]:
        label, _, d = argv[1].rpartition("=")
        parents[label or "parent"] = os.path.abspath(d)
        argv = argv[2:]
    names = argv or list(DEFAULT)
    _build.build_all([CC.H2O_KERNEL])
    fns = {"shipped": getattr(CC.H2O_KERNEL.lib(), CC.H2O_KERNEL.symbol)}
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name in names:
        rpt, split, seg, blocks = (int(v) for v in re.fullmatch(r"(\d+)x(\d+)x(\d+)@(\d+)", name).groups())
        so = os.path.join(out_dir, f"h2o_topk-{name}.so")
        flags = [f"-DCELLS_RPT={rpt}", f"-DCELLS_SPLIT={split}", f"-DCELLS_SEG={seg}", f"-DCELLS_MIN_BLOCKS={blocks}"]
        src = os.path.join(_build.CSRC, "h2o_topk.cu")
        jobs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", so, src],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    flagged = {}  # does a build's launch take the cell flags
    for label, d in parents.items():
        so = os.path.join(out_dir, f"h2o_topk-{label}.so")
        src = os.path.join(d, "h2o_topk.cu")
        flagged[label] = "live" in open(src).read().split("h2o_topk_launch", 1)[1].split(")", 1)[0]
        jobs[label] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)

    class Built:  # what sass_inner_loop reads of a kernel
        def __init__(self, so):
            self.so = so

        def _paths(self):
            return "", self.so

    logs = {"shipped": CC.H2O_KERNEL.ptxas_log}
    for name, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(out, file=sys.stderr)
            return 1
        logs[name] = out
        fn = getattr(ctypes.CDLL(so), "h2o_topk_launch")
        n_ptr = 7 if flagged.get(name, True) else 6
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    for name in ["shipped"] + list(jobs):
        so = CC.H2O_KERNEL._paths()[1] if name == "shipped" else jobs[name][1]
        regs = "; ".join(ln.split(":", 1)[-1].strip() for ln in logs[name].splitlines()
                         if "Used" in ln or "spill" in ln)
        st = S.sass_inner_loop(Built(so))
        print(f"{name} h2o_topk: {regs}; SASS hot loop {st['instructions']} instructions per {st['pairs']} pairs "
              f"= {st['instructions'] / max(st['pairs'], 1):.3f} per pair", flush=True)

    L = S.TRAIN_L
    x, y, yv, perm, _ = S.cluster_operands(seed=13)
    _, xs, y4, ctr = CC._prepare(x, y, yv, L, perm)
    cidx, _ = CC.h2o_candidates(x, y, yv, x_perm=perm, y_group=L)
    del x, y, yv
    F, P1, _ = xs.shape
    P2 = y4.shape[1]
    T, K = cidx.shape[1:]
    live = CC.cell_flags(y4)
    ones = torch.ones_like(live)
    d = torch.empty((F, P1), device="cuda")
    idx = torch.empty((F, P1), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        fn = fns["shipped" if name == "noskip" else name]
        flags = ((ones if name == "noskip" else live).data_ptr(),) if flagged.get(name, True) else ()
        rc = fn(xs.data_ptr(), y4.data_ptr(), ctr.data_ptr(), cidx.data_ptr(), *flags, d.data_ptr(),
                idx.data_ptr(), F, P1, P2, L, T, K, stream)
        S.require(rc == 0, f"{name}: launch failed ({rc})")

    run("shipped")
    ref = (d.clone(), idx.clone())
    timed = ["noskip"] + list(jobs)
    for name in timed:
        run(name)
        S.require(torch.equal(d, ref[0]) and torch.equal(idx, ref[1]), f"{name}: h2o_topk differs from the shipped build")
    print(f"h2o_topk F={F} P1={P1} P2={P2} y_group={L} K={K}: every variant equal to the shipped build; "
          f"cells with a valid point {int(live.sum())} of {live.numel()}", flush=True)
    for name in ["shipped"] + timed + timed[::-1] + ["shipped"]:
        print(f"{name}: h2o_topk {S.cuda_time_ms(lambda: run(name), reps=5):.3f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
