"""Rigid point-set registration (port of oakink2_tamf_tpu/utils/registration.py;
the reference dev_fn/transform/registration.py)."""

from __future__ import annotations

import torch

from ..core.transforms import assemble_T


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Least-squares rigid transform aligning src -> dst (Kabsch).

    src, dst: [..., N, 3]; weights: optional [..., N] (normalised to sum 1).
    Returns transf [..., 4, 4] with dst ~= src @ R^T + t; the SVD's
    reflection is folded out through sign(det), so R is a rotation."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device) if weights is None else weights
    w = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-12)

    mu_s = torch.sum(src * w[..., None], dim=-2, keepdim=True)
    mu_d = torch.sum(dst * w[..., None], dim=-2, keepdim=True)
    H = torch.einsum("...ni,...nj->...ij", (src - mu_s) * w[..., None], dst - mu_d)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    S = torch.eye(3, dtype=src.dtype, device=src.device).expand(H.shape).clone()
    S[..., 2, 2] = det
    R = Vt.transpose(-1, -2) @ S @ U.transpose(-1, -2)
    t = mu_d[..., 0, :] - torch.einsum("...ij,...j->...i", R, mu_s[..., 0, :])
    return assemble_T(t, R)
