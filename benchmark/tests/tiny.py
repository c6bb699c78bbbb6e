"""Tiny versions of the cells for the CPU tests: the same files, entry points
and checks at widths and sizes a test run holds."""

from __future__ import annotations

import copy
import json
import os
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("g_mdm_l.train_fused", "g_mdm_l.sample_ddpm", "r_refine.train_cull")


def shrink(spec: dict) -> dict:
    """The cell at latent 32, 2 layers, 16 frames, 2 slots of 256 points,
    batch 4 (a call of 4 segments; 2 rows a rank on several chips), 20
    diffusion steps."""
    spec = copy.deepcopy(spec)
    cfg = spec["cfg"]
    for k in ("g_model", "r_model"):
        if k in cfg:
            cfg[k].update(latent_dim=32, ff_size=64, num_layers=2)
    if "diffusion" in cfg:
        cfg["diffusion"]["steps"] = 20
    cfg["train"]["batch_size"] = 2 if int(spec["cell"]["chips"]) > 1 else 4
    cfg["data"].update(seq_len=16, max_nobj=2, n_obj_points=256, min_len=4)
    if "segments_per_call" in spec["traffic"]:
        spec["traffic"]["segments_per_call"] = 4
    spec["traffic"].pop("min_seconds", None)
    spec["traffic"].update(length_quantiles=[4, 16], obj_counts=[1, 2])
    return spec


def tiny_spec(cell: str) -> dict:
    from benchmark.harness import load_cell

    return shrink(load_cell(ROOT, cell))


def run_tiny(cell: str, seed: int = 2**31 + 17, trace: bool = False) -> dict:
    """One run of the tiny cell on the CPU through the harness's `execute`
    (everything but its look for a chip); returns the result's object."""
    from benchmark.harness import execute

    torch.set_num_threads(2)
    return execute(tiny_spec(cell), seed, 0.05, trace, torch.device("cpu"), time.perf_counter())



def spawn_ranks(target, world: int, device: str, *args) -> list:
    """`target(device, group, *args)` in `world` spawned processes, rank r on
    `device` ("cpu", or "cuda" for card r) in a process group (gloo on the
    CPU, NCCL on the cards) with `group` the ranks' gloo group; returns what
    each rank's call returned (JSON), in rank order."""
    import multiprocessing

    from benchmark.lib import ranks

    port = ranks.free_port()
    with tempfile.TemporaryDirectory() as handoff:
        mp = multiprocessing.get_context("spawn")
        procs = [mp.Process(target=_rank, args=(target, r, world, device, port, handoff, args)) for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if codes != [0] * world:
            raise RuntimeError(f"ranks exited with {codes}")
        got = []
        for r in range(world):
            with open(os.path.join(handoff, f"rank{r}.json")) as f:
                got.append(json.load(f)["result"])
    return got


def _rank(target, rank, world, device, port, handoff, args) -> None:
    import torch.distributed as dist

    from benchmark.harness import set_precision
    from benchmark.lib import ranks

    torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    set_precision(dev)
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        result = target(dev, dist.new_group(backend="gloo"), *args)
    finally:
        dist.destroy_process_group()
    ranks.write(handoff, rank, result, [])


def run_tiny_ranks(cell: str, world: int = 2, seed: int = 2**31 + 17, fault: str | None = None,
                   trace: bool = False, train: dict | None = None) -> dict:
    """The tiny cell on `world` gloo ranks on the CPU through the harness's
    `execute`, with the named fault of lib/faults.py planted in each rank
    and `train` over the configuration's train settings; returns the ranks'
    merged result."""
    from benchmark.lib import ranks

    return ranks.merge(spawn_ranks(_tiny_execute, world, "cpu", cell, seed, fault, trace, train or {}))


def _tiny_execute(device, group, cell, seed, fault, trace, train) -> dict:
    import torch.distributed as dist

    from benchmark.harness import execute
    from benchmark.lib import faults

    if fault is not None:
        faults.FAULTS[fault](setattr)
    spec = tiny_spec(cell)
    spec["cfg"]["train"].update(train)
    return execute(spec, seed, 0.05, trace, device, time.perf_counter(), rank=dist.get_rank(),
                   world=dist.get_world_size(), host_group=group)
