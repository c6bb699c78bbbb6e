"""Camera-frame skeleton overlay (port of oakink2_tamf_tpu/viz/overlay.py):
project hand joints/verts through camera intrinsics and draw them over an
RGB image; numpy arrays or CPU tensors in, uint8 numpy images out.

Closes the last viz-capability delta vs the reference's cv2 drawing stack
(dev_fn/util/vis_cv2_util.py:1-622 — skeleton/vert overlays on camera frames
used by its debug tooling). cv2 is not in this image, so rasterization is
pure numpy (sampled line segments + disk stamps) — same outputs (uint8 RGB
arrays), no native dependency, trivially testable.

Camera convention (the reference's): OpenCV pinhole — +z forward,
`cam_intr` = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], `cam_extr` a 4x4
world->camera rigid transform (identity when the points are already in the
camera frame). Points behind the camera (z <= eps) are dropped.
"""

from __future__ import annotations

import numpy as np

from .render import CHAIN_COLORS, HAND_LINKS, as_numpy


def _to_rgb(color) -> np.ndarray:
    if isinstance(color, str):  # "#rrggbb"
        c = color.lstrip("#")
        return np.array([int(c[i : i + 2], 16) for i in (0, 2, 4)], np.uint8)
    return np.asarray(color, np.uint8)


def project_points(
    points: np.ndarray,  # [N, 3] world (or camera) frame
    cam_intr: np.ndarray,  # [3, 3]
    cam_extr: np.ndarray | None = None,  # [4, 4] world->camera
    eps: float = 1e-6,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (uv [N, 2] float pixels, z [N] camera-frame depth). Points with
    z <= eps get uv = nan (callers drop them)."""
    p = np.asarray(as_numpy(points), np.float64)
    if cam_extr is not None:
        e = np.asarray(as_numpy(cam_extr), np.float64)
        p = p @ e[:3, :3].T + e[:3, 3]
    z = p[:, 2]
    k = np.asarray(as_numpy(cam_intr), np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = k[0, 0] * p[:, 0] / z + k[0, 2]
        v = k[1, 1] * p[:, 1] / z + k[1, 2]
    uv = np.stack([u, v], axis=1)
    uv[z <= eps] = np.nan
    return uv, z


def _stamp_disk(img: np.ndarray, u: int, v: int, radius: int, rgb: np.ndarray):
    h, w = img.shape[:2]
    lo_v, hi_v = max(0, v - radius), min(h, v + radius + 1)
    lo_u, hi_u = max(0, u - radius), min(w, u + radius + 1)
    if lo_v >= hi_v or lo_u >= hi_u:
        return
    yy, xx = np.mgrid[lo_v:hi_v, lo_u:hi_u]
    mask = (yy - v) ** 2 + (xx - u) ** 2 <= radius * radius
    img[yy[mask], xx[mask]] = rgb


def draw_line(
    img: np.ndarray, p0: np.ndarray, p1: np.ndarray, rgb, thickness: int = 2
):
    """Rasterize a segment by dense sampling + disk stamps (cv2.line stand-in;
    endpoints in float pixel coords). NaN endpoints are skipped."""
    if not (np.all(np.isfinite(p0)) and np.all(np.isfinite(p1))):
        return
    rgb = _to_rgb(rgb)
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    n = min(n, 4 * max(img.shape[:2]))  # off-screen segments stay bounded
    us = np.linspace(p0[0], p1[0], n)
    vs = np.linspace(p0[1], p1[1], n)
    r = max(0, thickness // 2)
    for u, v in zip(np.round(us).astype(int), np.round(vs).astype(int)):
        _stamp_disk(img, u, v, r, rgb)


def draw_skeleton_overlay(
    image: np.ndarray,  # [H, W, 3] uint8 (modified copy returned)
    joints: np.ndarray,  # [21, 3] world (or camera) frame, MANO joint order
    cam_intr: np.ndarray,
    cam_extr: np.ndarray | None = None,
    *,
    thickness: int = 2,
    joint_radius: int = 3,
) -> np.ndarray:
    """Draw the 21-joint MANO skeleton over a camera frame, one color per
    finger chain (vis_cv2_util's skeleton view). Returns a new image."""
    img = np.array(as_numpy(image), dtype=np.uint8, copy=True)
    uv, _ = project_points(joints, cam_intr, cam_extr)
    for i, (a, b) in enumerate(HAND_LINKS):
        draw_line(img, uv[a], uv[b], CHAIN_COLORS[i // 4], thickness=thickness)
    for j in range(uv.shape[0]):
        if np.all(np.isfinite(uv[j])):
            u, v = int(round(uv[j, 0])), int(round(uv[j, 1]))
            _stamp_disk(img, u, v, joint_radius, _to_rgb("#ffffff"))
    return img


def draw_verts_overlay(
    image: np.ndarray,
    verts: np.ndarray,  # [V, 3]
    cam_intr: np.ndarray,
    cam_extr: np.ndarray | None = None,
    *,
    color="#00bfff",
    radius: int = 0,
) -> np.ndarray:
    """Scatter projected verts (or any point cloud) over a camera frame."""
    img = np.array(as_numpy(image), dtype=np.uint8, copy=True)
    uv, _ = project_points(verts, cam_intr, cam_extr)
    rgb = _to_rgb(color)
    h, w = img.shape[:2]
    ok = np.all(np.isfinite(uv), axis=1)
    ui = np.round(uv[ok, 0]).astype(int)
    vi = np.round(uv[ok, 1]).astype(int)
    inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    if radius <= 0:
        img[vi[inside], ui[inside]] = rgb
    else:
        for u, v in zip(ui[inside], vi[inside]):
            _stamp_disk(img, u, v, radius, rgb)
    return img
