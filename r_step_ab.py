#!/usr/bin/env python3
"""Compare the cull-route R training step of two or more checkouts on one
GPU, in turns.

    python3 r_step_ab.py DIR [DIR ...]

Each DIR is a checkout of this repository (e.g. an earlier commit unpacked
with `git archive` into the git-ignored tmp/). For each DIR, in the order
given, a process of its own builds DIR's R kernels from its ops/csrc and
runs DIR's chip_smoke.r_train_main_path: one warm-up and 3 timed steps of
the R main path (arch_refine, batch 64 x 160 frames x 4 objects x 8192
points, target_h2o cached) and the step's split, each alone on the same
batch. Give the trees as parent, change, change, parent to see the drift
of the card between the turns.
"""

from __future__ import annotations

import os
import subprocess
import sys

TURN = """
import os, sys
os.chdir(sys.argv[1])
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from oakink2_tamf_tpu_torch._device import set_fp32_precision
from oakink2_tamf_tpu_torch.ops import _build
set_fp32_precision()
_build.build_all(list(cs._r_kernel_objects().values()))
print("=== tree", sys.argv[1], flush=True)
cs.r_train_main_path()
"""


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("r_step_ab: no CUDA device", file=sys.stderr)
        return 1
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for d in argv:
        subprocess.run([sys.executable, "-c", TURN, os.path.abspath(d)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
