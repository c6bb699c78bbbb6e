"""Seeds derived from the run's `--seed` (any whole number) and a tag, so each
draw of a run has a seed of its own and the same `--seed` gives the same
inputs, weights and noise."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def sub(seed: int, tag: str) -> int:
    """A 63-bit seed for (seed, tag)."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:8], "little") >> 1


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub(seed, tag))


def device_generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub(seed, tag))


def seed_global(device, seed: int, tag: str) -> None:
    """Seed torch's global generators (dropout draws from them) on the host
    and on `device`."""
    s = sub(seed, tag)
    torch.manual_seed(s)
    if torch.device(device).type == "cuda":
        torch.cuda.manual_seed(s)
