"""Tiny versions of the cells for the CPU tests: the same files, entry points
and checks at widths and sizes a test run holds."""

from __future__ import annotations

import copy
import os
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("g_mdm_l.train_fused", "g_mdm_l.sample_ddpm", "r_refine.train_cull")


def shrink(spec: dict) -> dict:
    """The cell at latent 32, 2 layers, 16 frames, 2 slots of 256 points,
    batch 4 (a call of 4 segments), 20 diffusion steps."""
    spec = copy.deepcopy(spec)
    cfg = spec["cfg"]
    for k in ("g_model", "r_model"):
        if k in cfg:
            cfg[k].update(latent_dim=32, ff_size=64, num_layers=2)
    if "diffusion" in cfg:
        cfg["diffusion"]["steps"] = 20
    cfg["train"]["batch_size"] = 4
    cfg["data"].update(seq_len=16, max_nobj=2, n_obj_points=256, min_len=4)
    if "segments_per_call" in spec["traffic"]:
        spec["traffic"]["segments_per_call"] = 4
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

