"""The work a cell asks for, counted from its shapes and its generated inputs,
never taken from the program.

Flops: every matrix product of the trunk (forward, and twice that again for
the backward of a train step), attention over the cond tokens plus the
frames; MANO's blend shapes, joint regression and skinning for the side of
each sample; every nearest-neighbour search at 8 flops per valid (hand
vert, object point) pair of a live frame (a real object slot inside the
true length), whichever route the program takes. No recomputation.

A kernel's least time (`bound_s`) is the larger of its pairs' flops at the
FP32 peak and its operands read once and results written once at the HBM
bandwidth.
"""

from __future__ import annotations

import numpy as np

from .peaks import FP32_FLOPS, HBM_BYTES_PER_S

N_VERTS = 778
N_JOINTS_KIN = 16
FLOPS_PER_PAIR = 8


def trunk_forward(cfg: dict, L: int, n_cond: int, streams: list[int], cond_in: list[int], nobj: int) -> float:
    """Flops of one sample's forward: per-frame input streams (`streams`: the
    input widths, the object stream applied to each of `nobj` slots when its
    width is obj_input_dim), their merge, the cond-token projections
    (`cond_in`), the encoder over L + n_cond tokens, the output head."""
    d, ff, layers = int(cfg["latent_dim"]), int(cfg["ff_size"]), int(cfg["num_layers"])
    S = L + n_cond
    per_frame = 0
    for w in streams:
        per_frame += 2 * w * d * (nobj if w == int(cfg["obj_input_dim"]) else 1)
    per_frame += 2 * len(streams) * d * d + 2 * d * d  # input merge
    per_frame += 2 * d * int(cfg["input_dim"])  # output head
    cond = sum(2 * w * d for w in cond_in)
    enc = layers * (S * (2 * d * 3 * d + 2 * d * d + 4 * d * ff) + 4 * S * S * d)
    return float(L * per_frame + cond + enc)


def g_forward(cfg: dict, L: int, nobj: int) -> float:
    d = int(cfg["latent_dim"])
    return trunk_forward(cfg, L, 5, [int(cfg["input_dim"]), int(cfg["obj_input_dim"])],
                         [d, d, int(cfg["clip_dim"]), int(cfg["hand_shape_dim"]), int(cfg["obj_embed_dim"])], nobj)


def r_forward(cfg: dict, L: int, nobj: int) -> float:
    return trunk_forward(cfg, L, 3, [int(cfg["input_dim"]), int(cfg["obj_input_dim"]), N_VERTS],
                         [int(cfg["hand_shape_dim"]), int(cfg["obj_embed_dim"])], nobj)


def mano_frame() -> float:
    """One frame of one side: shape and pose blend shapes, joint regression,
    the kinematic chain's 4x4 products and the joints' offsets, the blended
    rotations and translations, and their application."""
    v, j = N_VERTS, N_JOINTS_KIN
    return float(2 * v * 3 * (10 + 135) + 2 * j * v * 3 + (j - 1) * 2 * 4 * 4 * 4 + 2 * j * 3 * 3
                 + 2 * v * j * 12 + 2 * v * 9)


def live_frames(mask: np.ndarray, obj_mask: np.ndarray) -> int:
    """Real object slots inside the true length, summed over the batch."""
    return int(np.sum((np.asarray(mask) > 0)[:, None, :] & np.asarray(obj_mask, bool)[:, :, None]))


def search(live: int, n_points: int) -> float:
    return float(FLOPS_PER_PAIR * live * N_VERTS * n_points)


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def signed_bytes(live: int, n_clouds: int, n_points: int) -> float:
    """#6: hand verts and normals of the live frames and the clouds read; both
    signed distances and the object side's nearest index written."""
    return 4.0 * (live * N_VERTS * 6 + n_clouds * n_points * 3 + live * (N_VERTS + 2 * n_points))


def dist_loss_bytes(live: int, n_clouds: int, n_points: int) -> float:
    """#8: hand verts, normals and the GT distances of the live frames, the
    clouds and the contact weights read; the two per-frame sums and the
    hand's gradient written."""
    return 4.0 * (live * (N_VERTS * 6 + N_VERTS + n_points) + n_clouds * n_points * 3 + N_VERTS
                  + live * (2 + N_VERTS * 3))
