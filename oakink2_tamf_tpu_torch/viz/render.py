"""Headless visualization of hand/object sequences (port of
oakink2_tamf_tpu/viz/render.py).

The reference ships three interactive/offscreen viz stacks (dev_fn/viz
VizControl on Open3D, vis_pyrender_util, vis_cv2_util skeleton drawing) used
by the debug scripts. This module gives their headless equivalents on
matplotlib, imported inside the functions that draw (a machine without
matplotlib or PIL imports the module all the same):

- `draw_skeleton_frame`: 3-D joints + object clouds for one frame
- `render_sequence_grid`: a strip of frames (the debug-script view)
- `save_sequence_gif`: animation export (PIL)

Arrays are numpy arrays or CPU tensors (`as_numpy`). The 21-joint
connectivity follows core/mano.py's output ordering.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

# manotorch 21-joint order: wrist + 5 chains of (1,2,3,tip)
HAND_LINKS = [
    (0, 1), (1, 2), (2, 3), (3, 4),  # thumb
    (0, 5), (5, 6), (6, 7), (7, 8),  # index
    (0, 9), (9, 10), (10, 11), (11, 12),  # middle
    (0, 13), (13, 14), (14, 15), (15, 16),  # ring
    (0, 17), (17, 18), (18, 19), (19, 20),  # pinky
]
CHAIN_COLORS = ["#d62728", "#1f77b4", "#2ca02c", "#9467bd", "#8c564b"]


def as_numpy(x):
    """A CPU tensor (detached) or anything np.asarray takes -> numpy; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _ax3d(fig, pos):
    if isinstance(pos, tuple):
        ax = fig.add_subplot(*pos, projection="3d")
    else:
        ax = fig.add_subplot(pos, projection="3d")
    ax.set_xticks([])
    ax.set_yticks([])
    ax.set_zticks([])
    return ax


def draw_skeleton_frame(
    ax,
    joints: np.ndarray,  # [21, 3]
    obj_points: Optional[np.ndarray] = None,  # [N, 3]
    joints_ref: Optional[np.ndarray] = None,  # [21, 3] e.g. GT overlay
) -> None:
    joints, obj_points, joints_ref = as_numpy(joints), as_numpy(obj_points), as_numpy(joints_ref)
    for i, (a, b) in enumerate(HAND_LINKS):
        color = CHAIN_COLORS[i // 4]
        ax.plot(*np.stack([joints[a], joints[b]]).T, color=color, lw=2)
    ax.scatter(*joints.T, s=6, c="k")
    if joints_ref is not None:
        for a, b in HAND_LINKS:
            ax.plot(*np.stack([joints_ref[a], joints_ref[b]]).T, color="gray", lw=1, alpha=0.6)
    if obj_points is not None and len(obj_points):
        sub = obj_points[:: max(1, len(obj_points) // 500)]
        ax.scatter(*sub.T, s=1, c="#ff7f0e", alpha=0.4)

    allpts = [joints] + ([obj_points] if obj_points is not None and len(obj_points) else [])
    pts = np.concatenate(allpts, axis=0)
    c = pts.mean(axis=0)
    r = max(float(np.abs(pts - c).max()), 1e-3)
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)


def render_sequence_grid(
    joints_seq: np.ndarray,  # [L, 21, 3]
    obj_points_seq: Optional[np.ndarray] = None,  # [L, N, 3]
    joints_ref_seq: Optional[np.ndarray] = None,
    n_frames: int = 8,
    out_path: Optional[str] = None,
):
    """Render an evenly-spaced strip of frames; returns the figure."""
    joints_seq, obj_points_seq, joints_ref_seq = (as_numpy(a) for a in (joints_seq, obj_points_seq, joints_ref_seq))
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    L = len(joints_seq)
    idx = np.linspace(0, L - 1, min(n_frames, L)).astype(int)
    fig = plt.figure(figsize=(3 * len(idx), 3))
    for k, f in enumerate(idx):
        ax = _ax3d(fig, (1, len(idx), k + 1))
        draw_skeleton_frame(
            ax,
            joints_seq[f],
            obj_points_seq[f] if obj_points_seq is not None else None,
            joints_ref_seq[f] if joints_ref_seq is not None else None,
        )
        ax.set_title(f"t={f}", fontsize=8)
    fig.tight_layout()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
    return fig


def save_sequence_gif(
    joints_seq: np.ndarray,
    out_path: str,
    obj_points_seq: Optional[np.ndarray] = None,
    fps: int = 10,
    stride: int = 1,
) -> None:
    """Animated GIF of the sequence (PIL)."""
    joints_seq, obj_points_seq = as_numpy(joints_seq), as_numpy(obj_points_seq)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    frames = []
    for f in range(0, len(joints_seq), stride):
        fig = plt.figure(figsize=(3, 3))
        ax = _ax3d(fig, 111)
        draw_skeleton_frame(
            ax, joints_seq[f], obj_points_seq[f] if obj_points_seq is not None else None
        )
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())
        frames.append(Image.fromarray(buf[..., :3]))
        plt.close(fig)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    frames[0].save(
        out_path, save_all=True, append_images=frames[1:], duration=1000 // fps, loop=0
    )
