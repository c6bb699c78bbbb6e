"""launch/debug_refine of the port against the JAX package's
scripts/debug_refine.py (loaded by path) on config/synthetic_smoke.yml on
the CPU, in tmp_path, on one shared reference-layout .pt. The arrays each
hands to viz/render.render_sequence_grid, viz/html_viewer.export_html_viewer
and its h2o strip are captured by monkeypatch (the originals still write
the files).

Tolerances, float32 on both sides: joints and the three h2o arrays rtol
1e-4 / atol 1e-6 (R's forward, MANO and the nearest-point search in another
order: the JAX CPU route expands |x - y|^2); the printed MPJPE and
|h2o - target| numbers (mm, 2 decimals) within 1e-4 of themselves plus one
printed unit.
"""

import argparse
import re

import numpy as np
import torch

from oakink2_tamf_tpu_torch.launch import debug_refine, param
from oakink2_tamf_tpu_torch.launch.train_r import build_refine_net
from oakink2_tamf_tpu_torch.runtime.config import ConfigRegistry
from test_torch_debug_launchers import CPU, SMOKE, _Calls, _capture, _files, _np, _one_torch_thread, _script  # noqa: F401


def _numbers(line):
    return [float(v) for v in re.findall(r"-?\d+\.\d+", line)]


def test_debug_refine_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """Both scripts on one reference-layout .pt (the port's R at the smoke
    config's widths from seed 3, saved as a bare state_dict; both run it
    under gelu_exact)."""
    reg = ConfigRegistry("ref")
    param.reg_model_param(reg)
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, ["--cfg", SMOKE])
    torch.manual_seed(3)
    ckpt = str(tmp_path / "r.pt")
    torch.save(build_refine_net(reg, activation="gelu_exact").state_dict(), ckpt)

    rec = _capture(monkeypatch, debug_refine)
    script = _script("debug_refine")
    strips = {"jax": _Calls(script.render_h2o_strip), "port": _Calls(debug_refine.render_h2o_strip)}
    monkeypatch.setattr(script, "render_h2o_strip", strips["jax"])
    monkeypatch.setattr(debug_refine, "render_h2o_strip", strips["port"])
    args = ["--n_samples", "2", "--html", "true", "--model_filepath", ckpt]
    out = debug_refine.main(CPU + args + ["--out", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    script.main(["--cfg", SMOKE] + args + ["--out", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out

    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == sorted(
        f"refine_{i:03d}{e}" for i in range(2) for e in (".html", "_h2o.png", "_overlay.png"))
    assert set(out) >= {"refine_hand_joints", "sample_h2o_dist", "target_h2o_dist"}
    # three strips per segment: sample vs GT, refined vs GT, refined with the cloud
    pc, jc = rec["port"]["render_sequence_grid"].calls, rec["jax"]["render_sequence_grid"].calls
    assert len(pc) == len(jc) == 6
    for (pa, pk), (ja, jk) in zip(pc, jc):
        np.testing.assert_allclose(_np(pa[0]), _np(ja[0]), rtol=1e-4, atol=1e-6)
        assert pk.keys() == jk.keys()
        for k in pk:
            np.testing.assert_allclose(_np(pk[k]), _np(jk[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for (pa, _), (ja, _) in zip(strips["port"].calls, strips["jax"].calls):
        assert list(pa[0]) == list(ja[0]) == ["sample", "refined", "target"]
        for k in pa[0]:
            np.testing.assert_allclose(_np(pa[0][k]), _np(ja[0][k]), rtol=1e-4, atol=1e-6, err_msg=k)
    plines = [ln for ln in port_out.splitlines() if "MPJPE" in ln]
    jlines = [ln for ln in jax_out.splitlines() if "MPJPE" in ln]
    assert len(plines) == len(jlines) == 2
    for p, j in zip(plines, jlines):
        assert re.sub(r"-?\d+\.\d+", "#", p.replace(str(tmp_path / "port"), "X")) == re.sub(
            r"-?\d+\.\d+", "#", j.replace(str(tmp_path / "jax"), "X"))
        for a, b in zip(_numbers(p.split("| wrote")[0]), _numbers(j.split("| wrote")[0])):
            assert abs(a - b) <= 1e-4 * abs(b) + 0.01, (p, j)
