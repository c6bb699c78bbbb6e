"""Run one cell of the benchmark of oakink2_tamf_tpu_torch:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, this folder and the
port. The last line of standard output is the result's JSON object; the
numbers that decide `correct` are the last lines of standard error.
"""

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pin_caches() -> None:
    """Every cache a library may write goes inside the checkout, at fixed
    paths, unless the caller gave one; libraries that would load JAX by
    themselves are told not to."""
    base = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(base, "nv_compute"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


if __name__ == "__main__":
    _pin_caches()
    sys.path[0] = ROOT  # the checkout, not this folder, is the import root
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], ROOT, PROCESS_START))
