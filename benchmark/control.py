"""The readings the limits of `correct` are set from, for one cell, on several
seeds in one process:

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 [--seconds 1]

Per seed it runs the cell as a run does (set-up, its checked steps or
calls, a short window) and prints one JSON line with the compared numbers
of the program against the reference (the lower readings), of the
reference computed in TF32 in the program's place (the control: the upper
readings), and, for a training cell, of the reference on half of each
batch (the planted fault of a step that leaves half its batch out). The
benchmark's own runs never run this.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    import argparse
    import json

    import torch

    from benchmark.entries.common import Context, free_device
    from benchmark.harness import find_cell, load_json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find_cell(bench, args.workload)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    here = os.path.join(ROOT, "benchmark")
    cfg = load_json(os.path.join(ROOT, config["file"]))
    traffic = load_json(os.path.join(here, "traffic", f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(here, "limits", f"{cell['name']}.json"))
    import importlib

    entry = importlib.import_module(f"benchmark.entries.{traffic['entry']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = Context(cfg=cfg, traffic=traffic, limits=limits, seed=seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda", 0), control=True)
        out = entry.run(ctx)
        free_device(ctx.device)
        line = {"workload": cell["name"], "seed": seed, "seconds": time.perf_counter() - t0,
                "program": {n: v for n, v, _ in out["checks"]},
                **{k: {n: v for n, v, _ in c} for k, c in out["readings"].items()},
                "notes": ctx.notes}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main(sys.argv[1:]))
