"""Runs one cell of BENCHMARK.json and prints its result.

Everything is found by name: the cell in BENCHMARK.json names its
configuration (whose file is given there) and its traffic mix
(benchmark/traffic/<traffic>.json, whose `min_seconds`, where it has one,
lengthens a shorter --seconds), the mix names its entry
(benchmark/entries/<entry>.py) and the cell's limits on the compared
numbers live in benchmark/limits/<cell>.json. With `--trace 1` each
per-layer metric listed for the cell is read by its own reader,
benchmark/layer_metrics/<metric>.py, whose `read(run)` returns a number or
None (then the metric is left out of the line), or raises where what it
reads contradicts itself. A cell whose `chips` is over 1 runs as that many
rank processes, one per card (benchmark/lib/ranks.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "oakink2_tamf_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or with
    a trace its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ((cell in m["workloads"]) if "workloads" in m else (m["moves"] in moved))]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"benchmark.layer_metrics.{name}",
                                                  os.path.join(HERE, "layer_metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the timed window's length, peak and
    counts, and with --trace the traced window's reading and counts."""

    window_s: float
    trace: object  # lib.trace.TraceSummary of the traced window, or None
    memory_peak: int
    layer: dict  # the entry's counts for the timed window
    traced: dict  # the entry's counts for the traced window
    power_limit_w: float | None
    chips: int = 1  # the cell's ranks, one card each


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell of several chips (benchmark/lib/ranks.py), never given by hand
    for name, kind in (("--rank", int), ("--world", int), ("--port", int), ("--handoff", str), ("--t0", float)):
        ap.add_argument(name, type=kind, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank-device", choices=("cuda", "cpu"), default="cuda", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def load_cell(root: str, name: str) -> dict:
    """The cell's entry in BENCHMARK.json with its configuration, traffic mix
    and limits, each read from its own file."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = find_cell(bench, name)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return {"bench": bench, "cell": cell, "cfg": load_json(os.path.join(root, config["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")),
            "limits": load_json(os.path.join(HERE, "limits", f"{cell['name']}.json"))}


def execute(spec: dict, seed: int, seconds: float, trace: bool, device, process_start: float,
            log=lambda line: None, rank: int = 0, world: int = 1, host_group=None) -> dict:
    """Set up, run and check the cell on `device` (as `rank` of `world`
    processes); returns the result's object. `spec` is load_cell's."""
    import torch

    from .entries.common import Context
    from .lib import peaks

    bench, cell = spec["bench"], spec["cell"]
    seconds = max(seconds, float(spec["traffic"].get("min_seconds", 0)))  # a mix may ask for a longer window
    t_import = time.perf_counter()
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context
    t_context = time.perf_counter()
    entry = importlib.import_module(f"benchmark.entries.{spec['traffic']['entry']}")
    ctx = Context(cfg=spec["cfg"], traffic=spec["traffic"], limits=spec["limits"], seed=seed, seconds=seconds,
                  trace=trace, device=device, rank=rank, world=world,
                  host_group=host_group)
    ctx.marks += [("imports", t_import), ("the CUDA context", t_context)]
    out = entry.run(ctx)
    setup_s = ctx.window.t0 - process_start

    metrics = {}
    summary, peak = ctx.traced.summary if trace else None, ctx.window.memory_peak
    if world > 1:  # the fullest card's peak, the busy time averaged over the cards
        from .lib import ranks

        peak = int(ranks.over_ranks(peak, "max", host_group))
        if summary is not None:
            summary = dataclasses.replace(summary, busy_s=ranks.over_ranks(summary.busy_s, "mean", host_group))
    run = Run(window_s=ctx.window.seconds, trace=summary, memory_peak=peak, layer=out["layer"],
              traced=out.get("traced", {}),
              power_limit_w=peaks.power_limit_w() if device.type == "cuda" else None, chips=world)
    for m in cell_metrics(bench, cell["name"], trace):
        if trace:
            v = load_reader(m["name"])(run)
        elif m["name"] == "setup_s":
            v = setup_s
        else:
            v = out["e2e"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    checks = out["checks"]
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(run.memory_peak), "power_limit_w": run.power_limit_w}
    result = {"correct": all(v <= lim for _, v, lim in checks), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    prev = process_start
    for phase, t in ctx.marks:
        log(f"phase {phase}: {t - prev:.3f} s")
        prev = t
    for line in ctx.notes:
        log(line)
    log(f"setup_s {setup_s:.6f}, window_s {ctx.window.seconds:.6f}, {time.perf_counter() - process_start:.3f} s "
        f"in all, power limit {run.power_limit_w} W")
    for n, v, lim in checks:
        log(f"check {n} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    return result


def main(argv, root: str, process_start: float) -> int:
    args = parse(argv)
    spec = load_cell(root, args.workload)
    cell = spec["cell"]

    import torch

    if args.rank is not None:
        return rank_main(args, spec, torch.device(args.rank_device, args.rank) if args.rank_device == "cuda"
                         else torch.device("cpu"))
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"{cell['name']} needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if importlib.util.find_spec("oakink2_tamf_tpu_torch") is None:
        return fail("the program (oakink2_tamf_tpu_torch) is not in this checkout")
    if chips > 1:
        return run_ranks(argv, chips, process_start)
    device = torch.device("cuda", 0)
    set_precision(device)
    lines = []
    result = execute(spec, args.seed, args.seconds, bool(args.trace), device, process_start, lines.append)
    return report(result, lines)


def set_precision(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations compute in float32
    torch.backends.cudnn.allow_tf32 = False


def report(result: dict, lines: list[str]) -> int:
    """Prints the lines and, last, the result; refuses where JAX or the JAX
    package is loaded in this process."""
    bad = forbidden_modules()
    if bad:
        return fail(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}")
    for line in lines:  # the compared numbers come last
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run_ranks(argv, world: int, process_start: float, rank_device: str = "cuda") -> int:
    """A cell of several chips: `world` rank processes (lib/ranks.py), their
    results merged and printed here."""
    from .lib import ranks

    try:
        got = ranks.launch(os.path.join(HERE, "run.py"), list(argv), world, process_start, rank_device)
    except (RuntimeError, OSError, ValueError) as e:
        return fail(str(e))
    result = ranks.merge([g["result"] for g in got])
    lines = [line for line in got[0]["lines"] if not line.startswith("check ")]
    lines += [f"check {n} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}"
              for n, c in result["checks"].items()]
    return report(result, lines)


def rank_main(args, spec: dict, device) -> int:
    """One rank of a cell of several chips: joins the process group, runs the
    cell on its device and hands its result to the parent through a file."""
    import torch.distributed as dist

    from .lib import ranks

    set_precision(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank)
    try:
        lines = []
        result = execute(spec, args.seed, args.seconds, bool(args.trace), device, args.t0, lines.append,
                         rank=args.rank, world=args.world, host_group=dist.new_group(backend="gloo"))
    finally:
        dist.destroy_process_group()
    bad = forbidden_modules()
    if bad:
        return fail(f"rank {args.rank}: modules of JAX or the JAX package are loaded: {', '.join(bad)}")
    ranks.write(args.handoff, args.rank, result, lines)
    return 0
