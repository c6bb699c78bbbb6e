#!/usr/bin/env python3
"""Compare the R training step of two or more checkouts on one GPU, in
turns.

    python3 r_step_ab.py [--route cull|all-pairs] DIR [DIR ...]

Each DIR is a checkout of this repository (e.g. an earlier commit unpacked
with `git archive` into the git-ignored tmp/). For each DIR, in the order
given, a process of its own imports DIR's package (oakink2_tamf_tpu_torch),
builds its R kernels from DIR's ops/csrc and runs this checkout's
chip_smoke.r_train_main_path on it, so every turn is measured by the same
code: one warm-up and 3 timed steps of the R main path (arch_refine, batch
64 x 160 frames x 4 objects, target_h2o cached) on the route given (cull,
the default: 8192 points, #2 and #3; all-pairs: 2048 points, #1 and #4),
the step's split, each piece alone on the same batch, and the route's
kernels on the operands the step hands them. Give the trees as parent,
change, change, parent to see the drift of the card between the turns.
"""

from __future__ import annotations

import os
import subprocess
import sys

TURN = """
import importlib.util, os, sys
tree, smoke, route = sys.argv[1:4]
os.chdir(tree)
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("chip_smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import oakink2_tamf_tpu_torch
from oakink2_tamf_tpu_torch._device import set_fp32_precision
from oakink2_tamf_tpu_torch.ops import _build
cs.require(os.path.dirname(os.path.dirname(os.path.abspath(oakink2_tamf_tpu_torch.__file__))) == tree,
           f"the package was not imported from {tree}")
set_fp32_precision()
_build.build_all(list(cs._r_kernel_objects().values()))
print("=== tree", tree, "route", route, flush=True)
cs.r_train_main_path(route)
"""


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("r_step_ab: no CUDA device", file=sys.stderr)
        return 1
    route = "cull"
    if argv[:1] == ["--route"]:
        route, argv = argv[1], argv[2:]
    if not argv or route not in ("cull", "all-pairs"):
        print(__doc__, file=sys.stderr)
        return 2
    smoke = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
    for d in argv:
        subprocess.run([sys.executable, "-c", TURN, os.path.abspath(d), smoke, route], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
