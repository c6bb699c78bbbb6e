"""Seeding with a per-rank offset (port of oakink2_tamf_tpu/utils/seeding.py;
reference dev_fn/util/random_util.setup_seed, launch/train.py:486-489).

The host RNGs (python `random`, numpy's global state) and torch's global
generator, which draws dropout and G's cond mask, are seeded
`seed + rank` so that ranks draw different masks for their different rows.
What every rank must draw alike (the weights at init, the train step's
timesteps and q_sample noise over the global batch) comes from generators
seeded without the offset.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..parallel import mesh


def setup_seed(seed: int) -> torch.Generator:
    """Seed the host RNGs and torch's global generator with seed + rank and
    return a (CPU) torch.Generator seeded the same."""
    eff = seed + mesh.rank()
    random.seed(eff)
    np.random.seed(eff % (2**32))
    torch.manual_seed(eff)
    return torch.Generator().manual_seed(eff)
