"""Point-cloud helpers (copy of oakink2_tamf_tpu/utils/pc_util.py's sort)."""

from __future__ import annotations

import numpy as np


def spatial_sort_indices(points: np.ndarray, leaf: int = 128) -> np.ndarray:
    """Permutation making contiguous `leaf`-sized blocks spatially compact
    (balanced recursive median split along the widest axis).

    Same `np.argpartition` calls as the JAX package, so the permutation is
    identical. Used on the canonical object clouds at collate time and on the
    MANO template (core/mano.hand_template_perm): the culled h2o kernel's
    region/tile bounds are tight only on compact blocks. Correctness never
    depends on it, only speed."""
    points = np.asarray(points)
    n = points.shape[0]
    out: list[np.ndarray] = []

    def rec(ids: np.ndarray) -> None:
        if len(ids) <= leaf:
            out.append(ids)
            return
        p = points[ids]
        ax = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        # split at a multiple of `leaf` so blocks never straddle the cut
        half = max(leaf, (len(ids) // 2 // leaf) * leaf)
        part = np.argpartition(p[:, ax], half)
        rec(ids[part[:half]])
        rec(ids[part[half:]])

    rec(np.arange(n))
    return np.concatenate(out)
