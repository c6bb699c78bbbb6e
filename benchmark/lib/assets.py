"""The stand-ins for the licensed assets, made by the benchmark and handed to
both the program and the reference: the synthetic MANO hand (a frozen copy
of oakink2_tamf_tpu_torch/core/mano.py `synthetic_mano_model`, seed 0 per
side, as the program's own loaders use) and the synthetic GrabNet contact
assets (edges of the MANO triangulation, seeded weights; frozen copy of
models/losses.py `load_contact_assets`' fallback)."""

from __future__ import annotations

import numpy as np
import torch

N_VERTS = 778
N_KIN_JOINTS = 16
PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
MANO_KEYS = ("v_template", "shapedirs", "posedirs", "j_regressor", "skin_weights", "faces")


def synthetic_mano(side: str = "right", seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed + (1 if side == "right" else 2))
    rest_joints = np.zeros((N_KIN_JOINTS, 3), dtype=np.float64)
    finger_base = {1: 0.25, 4: 0.10, 7: -0.25, 10: -0.05, 13: 0.45}
    for chain_root, y in finger_base.items():
        for i in range(3):
            rest_joints[chain_root + i] = (0.03 + 0.025 * (i + 1), y * 0.05, 0.0)
    rest_joints += rng.normal(scale=1e-3, size=rest_joints.shape)
    seg_centers = np.stack([rest_joints[j] if PARENTS[j] < 0 else 0.5 * (rest_joints[j] + rest_joints[PARENTS[j]])
                            for j in range(N_KIN_JOINTS)])
    assign = rng.integers(0, N_KIN_JOINTS, size=(N_VERTS,))
    v_template = seg_centers[assign] + rng.normal(scale=0.012, size=(N_VERTS, 3))
    d2 = ((v_template[:, None, :] - rest_joints[None, :, :]) ** 2).sum(-1)
    w = np.exp(-d2 / (2 * 0.015**2))
    skin_weights = w / w.sum(axis=1, keepdims=True)
    jr = np.exp(-d2.T / (2 * 0.008**2))
    jr = jr / jr.sum(axis=1, keepdims=True)
    shapedirs = rng.normal(scale=1e-3, size=(N_VERTS, 3, 10))
    posedirs = rng.normal(scale=1e-4, size=(N_VERTS, 3, 135))
    faces = rng.integers(0, N_VERTS, size=(1538, 3)).astype(np.int32)
    faces[:, 1] = (faces[:, 0] + 1 + faces[:, 1] % (N_VERTS - 1)) % N_VERTS
    faces[:, 2] = (faces[:, 0] + 1 + faces[:, 2] % (N_VERTS - 2)) % N_VERTS
    if side == "left":
        v_template = v_template * np.array([1.0, -1.0, 1.0])
        faces = faces[:, ::-1].copy()
    return {
        "v_template": np.asarray(v_template, np.float32),
        "shapedirs": np.asarray(shapedirs, np.float32),
        "posedirs": np.asarray(posedirs, np.float32),
        "j_regressor": np.asarray(jr, np.float32),
        "skin_weights": np.asarray(skin_weights, np.float32),
        "faces": np.asarray(faces, np.int32),
    }


def mano_pair() -> tuple[dict, dict]:
    return synthetic_mano("right"), synthetic_mano("left")


def reference_mano(device) -> tuple[dict[str, torch.Tensor], np.ndarray]:
    """(the float arrays stacked rh/lh as tensors on `device`, faces [2, F, 3])."""
    rh, lh = mano_pair()
    stack = {k: torch.from_numpy(np.stack([rh[k], lh[k]])).to(device) for k in MANO_KEYS if k != "faces"}
    return stack, np.stack([rh["faces"], lh["faces"]])


def contact_assets(faces_rh: np.ndarray) -> dict[str, np.ndarray]:
    e = np.concatenate([faces_rh[:, [0, 1]], faces_rh[:, [1, 2]], faces_rh[:, [2, 0]]], axis=0)
    vpe = np.unique(np.sort(e, axis=1), axis=0).astype(np.int64)
    w = np.random.default_rng(7).random(N_VERTS).astype(np.float32)
    return {"vpe": vpe, "v_weights": w, "v_weights2": np.power(w, 1.0 / 2.5).astype(np.float32)}


def reference_assets(device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in contact_assets(synthetic_mano("right")["faces"]).items()}
