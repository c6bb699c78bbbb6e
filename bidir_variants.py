#!/usr/bin/env python3
"""Time variants of the bidirectional search of kernels #6 (nn_signed) and
#8 (dist_loss) on one GPU.

    python3 bidir_variants.py [COLSxROWS@BLOCKS ...]

Each variant is a copy of ops/csrc, built into a git-ignored directory, with
bidir_common.cuh's BIDIR_COLS (columns per thread) and BIDIR_ROWS (rows per
group), and the kernels' __launch_bounds__ blocks per SM, set to the given
values (default: the ones compared in PERF.md, the shipped 4x8@4 among
them). For each variant it prints ptxas' registers and spills and the SASS
hot loop's instructions per pair (chip_smoke.sass_inner_loop), checks #6
bit-equal and #8 equal (gx_do within 1e-5 per frame) to the shipped build
at the G training shape (chip_smoke.training_scene, 40960 frames x 778 rows
x 8192 points), and times both kernels there in turns: shipped, each
variant, each variant again in reverse order, shipped.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

DEFAULT = ("8x1@2", "8x1@3", "16x1@2", "8x2@3", "8x4@2", "8x4@3", "4x8@3", "4x8@4")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bidir_variants: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import chip_smoke as S
    from oakink2_tamf_tpu_torch._device import set_fp32_precision
    from oakink2_tamf_tpu_torch.ops import _build
    from oakink2_tamf_tpu_torch.ops import chamfer_loss as CL
    from oakink2_tamf_tpu_torch.ops import chamfer_signed as CS

    set_fp32_precision()
    names = argv or list(DEFAULT)
    kernels = {"nn_signed": CS.KERNEL, "dist_loss": CL.KERNEL}
    _build.build_all(list(kernels.values()))
    libs = {("shipped", k): kern._lib for k, kern in kernels.items()}
    jobs = {}
    for name in names:
        cols, rows, blocks = (int(v) for v in re.fullmatch(r"(\d+)x(\d+)@(\d+)", name).groups())
        d = os.path.join(_build.BUILD_DIR, "variants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        p = os.path.join(d, "bidir_common.cuh")
        src = open(p).read()
        src = re.sub(r"#define BIDIR_COLS \d+", f"#define BIDIR_COLS {cols}", src)
        src = re.sub(r"#define BIDIR_ROWS \d+", f"#define BIDIR_ROWS {rows}", src)
        open(p, "w").write(src)
        for k in kernels:
            p = os.path.join(d, f"{k}.cu")
            src = re.sub(r"__launch_bounds__\(BIDIR_THREADS, \d+\)", f"__launch_bounds__(BIDIR_THREADS, {blocks})",
                         open(p).read())
            open(p, "w").write(src)
            so = os.path.join(d, f"{k}.so")
            jobs[(name, k)] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, p],
                                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)

    class Built:  # what sass_inner_loop reads of a kernel
        def __init__(self, so):
            self.so = so

        def _paths(self):
            return "", self.so

    for (name, k), (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(out, file=sys.stderr)
            return 1
        regs = "; ".join(ln.split(":", 1)[-1].strip() for ln in out.splitlines() if "Used" in ln or "spill" in ln)
        st = S.sass_inner_loop(Built(so))
        print(f"{name} {k}: {regs}; SASS hot loop {st['fast_path']} instructions without the row merge "
              f"per {st['pairs']} pairs = {st['fast_path'] / max(st['pairs'], 1):.3f} per pair", flush=True)
        libs[(name, k)] = ctypes.CDLL(so)

    def use(name):
        for k, kern in kernels.items():
            kern._lib = libs[(name, k)]
            kern._bind(kern._lib)

    L = S.TRAIN_L
    x, n, y, _, xv, og, hg, vw = S.training_scene(S.TRAIN_CLOUDS, L, seed=3)
    ops = CS.prepare(x, y, n, None, L)
    lops = CL.prepare(x, n, y, og, hg, vw, None, xv, L)
    use("shipped")
    ref6, ref8 = CS.launch(*ops, L), CL.launch(*lops, L)
    for name in names:
        use(name)
        got = CS.launch(*ops, L)
        S.require(all(torch.equal(a, b) for a, b in zip(got, ref6)), f"{name}: nn_signed differs from the shipped build")
        del got
        got = CL.launch(*lops, L)
        S.require(all(torch.equal(got[i], ref8[i]) for i in (0, 1, 3)) and S.scatter_close(got[2], ref8[2]),
                  f"{name}: dist_loss differs from the shipped build")
        del got
    del ref6, ref8
    torch.cuda.empty_cache()
    for name in ["shipped"] + names + names[::-1] + ["shipped"]:
        use(name)
        t6 = S.cuda_time_ms(lambda: CS.launch(*ops, L), reps=3)
        t8 = S.cuda_time_ms(lambda: CL.launch(*lops, L), reps=3)
        print(f"{name}: nn_signed {t6:.3f} ms, dist_loss {t8:.3f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
