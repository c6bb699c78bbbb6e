"""The port's viz modules (oakink2_tamf_tpu_torch/viz/) against the JAX
package's (viz/), on the CPU: the HTML viewer's file and the overlays'
pixel arrays are equal to JAX's for the same inputs, given as numpy
arrays or as CPU tensors; render's PNG strip and GIF are written. No
tolerance: bytes and pixels are compared for equality."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.viz import html_viewer as HV
from oakink2_tamf_tpu_torch.viz import overlay as OV
from oakink2_tamf_tpu_torch.viz import render as RD

K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])


def _joints(L=6):
    rng = np.random.default_rng(0)
    base = rng.normal(size=(21, 3)).astype(np.float32) * 0.05
    drift = np.linspace(0, 0.2, L, dtype=np.float32)[:, None, None]
    return base[None] + drift * np.array([1.0, 0.0, 0.0], np.float32)


def _tracks(as_tensor: bool):
    joints = _joints(8)
    cloud = np.random.default_rng(3).normal(size=(8, 5000, 3)).astype(np.float32)
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    return [{"name": "GT", "pos": conv(joints), "kind": "skeleton", "color": "#2ca02c"},
            {"name": "sample", "pos": conv(joints + 0.01), "kind": "points", "color": "#d62728"},
            {"name": "obj", "pos": conv(cloud), "kind": "cloud", "alpha": 0.5}]


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_html_viewer_equals_jax(tmp_path, as_tensor):
    from oakink2_tamf_tpu.viz.html_viewer import export_html_viewer

    got = HV.export_html_viewer(str(tmp_path / "port" / "seg.html"), _tracks(as_tensor), title="seg", fps=12,
                                max_points=512)
    want = export_html_viewer(str(tmp_path / "jax" / "seg.html"), _tracks(False), title="seg", fps=12,
                              max_points=512)
    html = open(got).read()
    assert html == open(want).read()
    assert html.startswith("<!DOCTYPE html>") and "const DATA = " in html


def test_html_viewer_default_title_and_validation(tmp_path):
    from oakink2_tamf_tpu.viz.html_viewer import export_html_viewer

    tracks = [{"name": "a", "pos": _joints(3)}]
    assert open(HV.export_html_viewer(str(tmp_path / "p.html"), tracks)).read() == open(
        export_html_viewer(str(tmp_path / "j.html"), tracks)).read()
    with pytest.raises(ValueError, match="no tracks"):
        HV.export_html_viewer(str(tmp_path / "x.html"), [])
    with pytest.raises(ValueError, match="share the frame count"):
        HV.export_html_viewer(str(tmp_path / "x.html"), [{"name": "a", "pos": np.zeros((4, 2, 3))},
                                                         {"name": "b", "pos": np.zeros((5, 2, 3))}])


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_overlays_equal_jax(as_tensor):
    from oakink2_tamf_tpu.viz import overlay as JOV

    rng = np.random.default_rng(0)
    joints = rng.normal(size=(21, 3)) * 0.05 + [0.0, 0.0, 0.5]
    joints[3, 2] = -0.2  # one joint behind the camera: its links are skipped
    verts = rng.normal(size=(300, 3)) * 0.08 + [0.0, 0.0, 0.5]
    extr = np.eye(4)
    extr[:3, 3] = [0.01, -0.02, 0.1]
    img = rng.integers(0, 255, size=(96, 128, 3), dtype=np.uint8)
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    got = OV.draw_skeleton_overlay(conv(img), conv(joints), conv(K), conv(extr), thickness=3)
    want = JOV.draw_skeleton_overlay(img, joints, K, extr, thickness=3)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != img).any()
    for radius in (0, 2):
        np.testing.assert_array_equal(
            OV.draw_verts_overlay(conv(img), conv(verts), conv(K), color="#00ff7f", radius=radius),
            JOV.draw_verts_overlay(img, verts, K, color="#00ff7f", radius=radius))
    uv, z = OV.project_points(conv(joints), conv(K))
    juv, jz = JOV.project_points(joints, K)
    np.testing.assert_array_equal(uv, juv)
    np.testing.assert_array_equal(z, jz)
    assert np.isnan(uv[3]).all()


def test_overlay_takes_a_tensor_that_requires_grad():
    joints = torch.randn((21, 3), dtype=torch.float64, requires_grad=True)
    with torch.no_grad():
        joints[:, 2] = joints[:, 2].abs() + 0.5
    uv, _ = OV.project_points(joints, K)
    assert uv.shape == (21, 2) and np.isfinite(uv).all()


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_render_writes_png_and_gif(tmp_path, as_tensor):
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    joints = _joints()
    obj = np.random.default_rng(1).normal(size=(6, 64, 3)).astype(np.float32)
    png = tmp_path / "strip.png"
    RD.render_sequence_grid(conv(joints), obj_points_seq=conv(obj), joints_ref_seq=conv(joints + 0.01), n_frames=4,
                            out_path=str(png))
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and png.stat().st_size > 1000
    gif = tmp_path / "seq.gif"
    RD.save_sequence_gif(conv(_joints(4)), str(gif), obj_points_seq=conv(obj[:4]), fps=5)
    assert gif.read_bytes()[:6] in (b"GIF87a", b"GIF89a")


def test_viz_imports_no_matplotlib_at_module_level():
    """The card's machine has neither matplotlib nor PIL: importing the
    viz package must not need them."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('matplotlib', 'PIL'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import oakink2_tamf_tpu_torch.viz.render, oakink2_tamf_tpu_torch.viz.overlay, "
            "oakink2_tamf_tpu_torch.viz.html_viewer\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
