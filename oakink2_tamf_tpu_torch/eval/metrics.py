"""Evaluation metrics: Contact Ratio, Solid Intersection Volume, PSKL-J, FID
(port of oakink2_tamf_tpu/eval/metrics.py; the reference's
script/compute_score/compute_score_{cr,siv,psklj,fid}.py).

- CR: share of frames whose least hand-vert to object-point distance is
  below 5 mm (cr.py:282-286). The distance core is core/geometry.min_cdist:
  the all-pairs kernel (#1) on CUDA tensors, its plain version on CPU
  tensors.
- SIV: volume (cm^3) of the object-interior grid cells inside the closed
  hand mesh, every `frame_stride`-th frame (siv.py:128-155). The interior
  grid comes from a containment test of the object mesh (the reference
  only ever reads sdf > 0 of a pysdf field); both containment tests run
  eval/inside_mesh.py on the host.
- PSKL-J: symmetric KL between the normalised FFT power spectra of joint
  accelerations, averaged over feature dims (psklj.py:279-317). Host numpy.
- FID: Frechet distance between SegmentEncoder encodings (fid.py:142-207).
  tr sqrtm(sigma1 sigma2) is taken as tr sqrtm(sqrt(sigma1) sigma2
  sqrt(sigma1)), a symmetric matrix with the same eigenvalues, by eigh in
  float64 with negative eigenvalues clamped to 0 (the JAX package calls
  scipy.linalg.sqrtm).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import geometry as G
from ..core import transforms as T
from .inside_mesh import check_mesh_contains

# ---------------------------------------------------------------------------
# Contact Ratio
# ---------------------------------------------------------------------------


def transf_merge_obj_pointcloud(obj_pointcloud, obj_traj, device: str | torch.device = "cpu") -> torch.Tensor:
    """[nobj, P, 3] canonical clouds + [nobj, L, 9] tslrot6d -> [L, nobj*P, 3]
    float32 world-frame merged cloud on `device` (cr.py:123-137)."""
    pc = torch.as_tensor(np.asarray(obj_pointcloud, np.float32), device=device)
    transf = T.tslrot6d_to_transf(torch.as_tensor(np.asarray(obj_traj, np.float32), device=device))
    moved = T.transf_point_array(transf, pc[:, None]).transpose(0, 1)  # [L, nobj, P, 3]
    return moved.reshape(moved.shape[0], -1, 3)


def contact_min_dists(hand_verts, merged_pc: torch.Tensor) -> np.ndarray:
    """Per-frame least distances [L] of hand_verts [L, 778, 3] to the merged
    cloud [L, Vo, 3], on the cloud's device."""
    hv = torch.as_tensor(hand_verts, dtype=torch.float32, device=merged_pc.device)
    return G.min_cdist(hv, merged_pc).cpu().numpy()


def contact_ratio(all_min_dists: np.ndarray, threshold: float = 0.005) -> float:
    """mean(dist < 5 mm) over all frames of all segments (cr.py:282-286)."""
    return float(np.mean(np.asarray(all_min_dists) < threshold))


# ---------------------------------------------------------------------------
# Solid Intersection Volume
# ---------------------------------------------------------------------------


def object_interior_grid(
    obj_verts: np.ndarray,
    obj_faces: np.ndarray,
    bbox_expand_ratio: float = 1.2,
    resolution: int = 100,
    impl: str = "native",
) -> tuple[np.ndarray, np.ndarray]:
    """Interior points of a watertight object mesh on a regular grid: the
    grid of dev_fn/util/sdf_util.process_sdf (mesh centred, bbox expanded by
    1.2, res^3 ticks), kept where the mesh contains them. Returns (interior
    points in the object frame, tick_unit [3])."""
    vmin = obj_verts.min(axis=0)
    vmax = obj_verts.max(axis=0)
    center = (vmin + vmax) / 2.0
    extent_expanded = (vmax - vmin) * bbox_expand_ratio
    tick_unit = extent_expanded / resolution

    ticks = [
        np.linspace(-extent_expanded[j] / 2.0, extent_expanded[j] / 2.0, resolution) for j in range(3)
    ]
    x, y, z = np.meshgrid(*ticks, indexing="ij")
    pts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    inside = check_mesh_contains(obj_verts - center, obj_faces, pts, impl=impl)
    return pts[inside] + center, tick_unit


def solid_intersection_volume(
    hand_verts: np.ndarray,
    hand_faces_closed: np.ndarray,
    obj_interior_points: Sequence[np.ndarray],
    obj_tick_units: Sequence[np.ndarray],
    obj_transf: Sequence[np.ndarray],
    impl: str = "native",
) -> float:
    """SIV of one frame in cm^3 (siv.py:128-155): per object, its interior
    grid points moved by the frame's transform (float32) and counted where
    the hand mesh contains them."""
    siv = 0.0
    for pts, tick, X in zip(obj_interior_points, obj_tick_units, obj_transf):
        if len(pts) == 0:
            continue
        el_vol = float(np.prod(tick))
        world = T.transf_point_array(torch.as_tensor(np.asarray(X, np.float32)),
                                     torch.as_tensor(np.asarray(pts, np.float32))).numpy()
        inside = check_mesh_contains(hand_verts, hand_faces_closed, world, impl=impl)
        siv += float(inside.sum()) * el_vol * 1e6
    return siv


# ---------------------------------------------------------------------------
# PSKL-J
# ---------------------------------------------------------------------------


def joint_power_spectrum(joints: np.ndarray) -> np.ndarray:
    """[L, J, 3] joints -> |FFT(accel)|^2 over time (psklj.py:285-293)."""
    acc = np.diff(joints, n=2, axis=0)
    return np.abs(np.fft.fft(acc, axis=0)) ** 2


def psklj(dataset_joints: Sequence[np.ndarray], model_joints: Sequence[np.ndarray]) -> tuple[float, float]:
    """Symmetric KL of the summed, normalised acceleration power spectra
    (psklj.py:279-317). All sequences share one padded length (the
    reference pads trailing frames with the last valid pose)."""
    ds_psd = np.stack([joint_power_spectrum(j) for j in dataset_joints], axis=0)
    md_psd = np.stack([joint_power_spectrum(j) for j in model_joints], axis=0)

    ds = ds_psd.sum(axis=0) + 1e-8
    md = md_psd.sum(axis=0) + 1e-8
    ds = ds / ds.sum(axis=0, keepdims=True)
    md = md / md.sum(axis=0, keepdims=True)

    num_feat = ds.shape[1]
    pskl_gt_model = float(np.sum(ds * np.log(ds / md)) / num_feat)
    pskl_model_gt = float(np.sum(md * np.log(md / ds)) / num_feat)
    return pskl_gt_model, pskl_model_gt


def pad_tail_with_last(joints: np.ndarray, valid_len: int) -> np.ndarray:
    """Freeze trailing padded frames at the last valid pose (psklj.py:270-272)."""
    out = joints.copy()
    if valid_len < len(out):
        out[valid_len:] = out[valid_len - 1]
    return out


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------


def calculate_activation_statistics(activations: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = np.mean(activations, axis=0)
    sigma = np.cov(activations, rowvar=False)
    return mu, sigma


def _sqrt_psd(a: np.ndarray) -> np.ndarray:
    """Square root of a symmetric positive semi-definite matrix (eigh;
    negative eigenvalues, rounding noise, clamped to 0)."""
    w, v = np.linalg.eigh((a + a.T) / 2.0)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def trace_sqrtm_product(sigma1: np.ndarray, sigma2: np.ndarray) -> float:
    """tr sqrtm(sigma1 sigma2) for covariances: the eigenvalues of
    sigma1 sigma2 are those of the symmetric sqrt(sigma1) sigma2
    sqrt(sigma1), non-negative up to rounding. NaN when an input is not
    finite (eigh would not converge)."""
    if not (np.isfinite(sigma1).all() and np.isfinite(sigma2).all()):
        return float("nan")
    s1 = _sqrt_psd(np.asarray(sigma1, np.float64))
    m = s1 @ np.asarray(sigma2, np.float64) @ s1
    w = np.linalg.eigvalsh((m + m.T) / 2.0)
    return float(np.sum(np.sqrt(np.clip(w, 0.0, None))))


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance of two Gaussians (fid.py:142-197): |mu1 - mu2|^2 +
    tr sigma1 + tr sigma2 - 2 tr sqrtm(sigma1 sigma2); when that trace is
    not finite, again with eps added to both diagonals."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    tr_covmean = trace_sqrtm_product(sigma1, sigma2)
    if not np.isfinite(tr_covmean):
        offset = np.eye(sigma1.shape[0]) * eps
        tr_covmean = trace_sqrtm_product(sigma1 + offset, sigma2 + offset)
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * tr_covmean)


def calculate_fid(act1: np.ndarray, act2: np.ndarray) -> float:
    return calculate_frechet_distance(
        *calculate_activation_statistics(act1), *calculate_activation_statistics(act2)
    )
