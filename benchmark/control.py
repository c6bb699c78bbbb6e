"""The readings the limits of `correct` are set from, for one cell, on several
seeds in one process (one process per card for a cell of several chips):

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 [--seconds 1] \
        [--faults none,no_allreduce,sum_allreduce]

Per seed and fault it runs the cell as a run does (set-up, its checked
steps or calls, a short window) and prints one JSON line. For `none` (the
default) the line holds the compared numbers of the program against the
reference (the lower readings), of the reference computed in TF32 in the
program's place (the control: the upper readings), and, for a training
cell, of the reference on half of each batch (the planted fault of a step
that leaves half its batch out). For a fault of lib/faults.py the fault is
planted in the program on every rank for that run alone, and the line
holds the program's numbers under it. Where a seed has faults, its
reference is run once for each precision and kept for the seed's later
runs: it takes nothing from the program. A cell of several chips runs as
rank processes (lib/ranks.py), each rank writing its lines to standard
error as they come, and each number printed is its worst rank's. The
benchmark's own runs never run this.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--faults", default="none", help="comma-separated: none (the sound program) or lib/faults.py names")
    # a rank of a cell of several chips (lib/ranks.py), never given by hand
    for name, kind in (("--rank", int), ("--world", int), ("--port", int), ("--handoff", str), ("--t0", float)):
        ap.add_argument(name, type=kind, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank-device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def readings(spec: dict, seeds, seconds: float, faults, device, rank: int = 0, world: int = 1,
             host_group=None) -> list[dict]:
    """One line per seed and fault, in that order: the program's compared
    numbers and, for the fault None (the sound program), the control's and
    the reference's half batch."""
    import importlib
    import json

    from benchmark.entries.common import Context, free_device
    from benchmark.harness import set_precision
    from benchmark.lib import faults as planted

    entry = importlib.import_module(f"benchmark.entries.{spec['traffic']['entry']}")
    set_precision(device)
    reference = getattr(entry, "reference", None)
    if reference is not None and any(f is not None for f in faults):
        entry.reference = _kept(reference)
    lines = []
    try:
        for seed in seeds:
            for fault in faults:
                undo = []
                if fault is not None:
                    planted.FAULTS[fault](lambda obj, name, value: (undo.append((obj, name, getattr(obj, name))),
                                                                    setattr(obj, name, value)))
                t0 = time.perf_counter()
                try:
                    ctx = Context(cfg=spec["cfg"], traffic=spec["traffic"], limits=spec["limits"], seed=seed,
                                  seconds=seconds, trace=False, device=device, control=fault is None, rank=rank,
                                  world=world, host_group=host_group)
                    out = entry.run(ctx)
                finally:
                    for obj, name, value in reversed(undo):
                        setattr(obj, name, value)
                free_device(device)
                line = {"workload": spec["cell"]["name"], "seed": seed, "fault": fault,
                        "seconds": time.perf_counter() - t0, "program": {n: v for n, v, _ in out["checks"]},
                        **{k: {n: v for n, v, _ in c} for k, c in out["readings"].items()}, "notes": ctx.notes}
                lines.append(line)
                if world > 1:
                    print(f"rank {rank}: {json.dumps(line)}", file=sys.stderr, flush=True)
    finally:
        if reference is not None:
            entry.reference = reference
    return lines


def _kept(reference):
    """`reference` run once for each seed, precision, keyword and scalar
    argument, the last seed's results kept (the other arguments are made
    from the seed)."""
    import torch

    kept = {}

    def once(ctx, *args, **kw):
        key = (ctx.seed, tuple(a for a in args if isinstance(a, (int, float, str))), tuple(sorted(kw.items())),
               torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        if key not in kept:
            if any(k[0] != ctx.seed for k in kept):
                kept.clear()
            kept[key] = reference(ctx, *args, **kw)
        return kept[key]

    return once


def worst(per_rank: list[dict]) -> dict:
    """One seed's line from every rank's: each number at its worst rank."""
    out = dict(per_rank[0], seconds=max(r["seconds"] for r in per_rank))
    for key, nums in per_rank[0].items():
        if isinstance(nums, dict):
            out[key] = {n: max(r[key][n] for r in per_rank) for n in nums}
    return out


def main(argv) -> int:
    import json

    import torch

    from benchmark.harness import load_cell
    from benchmark.lib import ranks

    args = parse(argv)
    spec = load_cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [None if f == "none" else f for f in args.faults.split(",")]
    world = int(spec["cell"]["chips"])
    if args.rank is not None:
        import torch.distributed as dist

        device = torch.device(args.rank_device, args.rank) if args.rank_device == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{args.port}", world_size=args.world, rank=args.rank)
        try:
            lines = readings(spec, seeds, args.seconds, faults, device, args.rank, args.world,
                             dist.new_group(backend="gloo"))
        finally:
            dist.destroy_process_group()
        ranks.write(args.handoff, args.rank, lines, [])
        return 0
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"control: {args.workload} needs {world} CUDA device(s)", file=sys.stderr)
        return 2
    if world == 1:
        lines = readings(spec, seeds, args.seconds, faults, torch.device("cuda", 0))
    else:
        got = ranks.launch(os.path.abspath(__file__), list(argv), world, time.perf_counter())
        lines = [worst([g["result"][i] for g in got]) for i in range(len(seeds) * len(faults))]
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    sys.exit(main(sys.argv[1:]))
