"""The port's debug and data launchers (launch/debug_sample, viz_seg,
save_cache_dict; debug_refine in tests/test_torch_debug_refine.py, and the
device check of all four here) against the JAX package's scripts of the same
names (scripts/*.py, loaded by path), on config/synthetic_smoke.yml on the
CPU, in tmp_path. The arrays each hands to viz/render.render_sequence_grid,
viz/html_viewer.export_html_viewer and its h2o strip are captured by
monkeypatch (the originals still write the files).

Tolerances, float32 on both sides:
- GT joints and moved object clouds: atol 1e-5 (the same MANO and rigid
  transforms; torch and XLA round the matmuls differently);
- debug_sample: the G sample is held to the port's own
  core/diffusion.p_sample_loop with the same seed (the JAX script's jitted
  chain takes no injected noise), bitwise.
"""

import argparse
import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
from oakink2_tamf_tpu_torch.launch import common, debug_refine, debug_sample, param, save_cache_dict, viz_seg
from oakink2_tamf_tpu_torch.launch.train_g import build_model
from oakink2_tamf_tpu_torch.models.refine_r import batch_recover_mano, stack_mano_models
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime.config import ConfigRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config", "synthetic_smoke.yml")
CPU = ["--cfg", SMOKE, "--runtime.device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch single-threaded under pytest-xdist, whose workers share the
    cores (tests/test_torch_r_train.py)."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Calls:
    """Records each call's arguments, then runs the original."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        self.calls.append((a, k))
        return self.fn(*a, **k)


def _capture(monkeypatch, port_module):
    """Record render_sequence_grid and export_html_viewer on both sides:
    -> {"jax": {...}, "port": {...}}."""
    from oakink2_tamf_tpu.viz import html_viewer as JH
    from oakink2_tamf_tpu.viz import render as JRD

    rec = {"jax": {}, "port": {}}
    for side, mod_r, mod_h in (("jax", JRD, JH), ("port", port_module, port_module)):
        for mod, name in ((mod_r, "render_sequence_grid"), (mod_h, "export_html_viewer")):
            rec[side][name] = _Calls(getattr(mod, name))
            monkeypatch.setattr(mod, name, rec[side][name])
    return rec


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _files(d):
    return sorted(os.listdir(d))


def test_viz_seg_matches_the_jax_script(tmp_path, monkeypatch):
    rec = _capture(monkeypatch, viz_seg)
    args = ["--indices", "0,3", "--html", "true"]
    got = viz_seg.main(CPU + args + ["--out", str(tmp_path / "port")])
    _script("viz_seg").main(["--cfg", SMOKE] + args + ["--out", str(tmp_path / "jax")])
    assert got == [str(tmp_path / "port" / f"seg_{i:04d}.png") for i in (0, 3)]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "seg_0000.html", "seg_0000.png", "seg_0003.html", "seg_0003.png"]
    for name in ("render_sequence_grid", "export_html_viewer"):
        assert len(rec["port"][name].calls) == len(rec["jax"][name].calls) == 2
    for (pa, pk), (ja, jk) in zip(rec["port"]["render_sequence_grid"].calls, rec["jax"]["render_sequence_grid"].calls):
        np.testing.assert_allclose(_np(pa[0]), _np(ja[0]), rtol=0, atol=1e-5)  # GT joints
        np.testing.assert_allclose(_np(pk["obj_points_seq"]), _np(jk["obj_points_seq"]), rtol=0, atol=1e-5)
    for (pa, pk), (ja, jk) in zip(rec["port"]["export_html_viewer"].calls, rec["jax"]["export_html_viewer"].calls):
        assert pk["title"] == jk["title"]
        for pt, jt in zip(pa[1], ja[1]):
            assert {k: v for k, v in pt.items() if k != "pos"} == {k: v for k, v in jt.items() if k != "pos"}
            np.testing.assert_allclose(_np(pt["pos"]), _np(jt["pos"]), rtol=0, atol=1e-5)


def test_viz_seg_gif(tmp_path):
    viz_seg.main(CPU + ["--indices", "2", "--gif", "true", "--out", str(tmp_path)])
    assert _files(tmp_path) == ["seg_0002.gif", "seg_0002.png"]


def _port_sample(n: int):
    """The G sample debug_sample should draw, built here from the port's
    own pieces: G from seed 0, the test split's first n segments collated
    at 2 x 512, p_sample_loop on a generator seeded 0."""
    reg = ConfigRegistry("ref")
    for fn in (param.reg_base_param, param.reg_mano_param, param.reg_model_param, param.reg_diffusion_param):
        fn(reg)
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, CPU)
    dev = torch.device("cpu")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(reg).eval()
    ds = common.build_dataset(reg, "test")
    batch = SegmentCollate(max_nobj=2, n_obj_points=512)([ds[i] for i in range(n)])
    db = common.device_batch(common.attach_text_emb(batch, common.build_clip(reg, dev)), dev)
    sched = D.tamf_schedule(int(reg.select("diffusion")["steps"]), "cosine")
    with torch.inference_mode():
        return D.p_sample_loop(PT.g_model_fn(model, PT.g_cond_from_batch(db)), sched, (n, db["pose_repr"].shape[1], 99),
                               device=dev, generator=torch.Generator().manual_seed(0), clip_denoised=False), db


class _Texts:
    """A stand-in for the JAX script's CLIP: zero text features. The JAX
    side's sample is only checked finite, and its random-init CLIP would
    take most of this test's time."""

    def encode_text(self, texts):
        return np.zeros((len(texts), 512), np.float32)


def test_debug_sample_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    from oakink2_tamf_tpu.launch import common as jcommon

    monkeypatch.setattr(jcommon, "build_clip", lambda reg: _Texts())
    rec = _capture(monkeypatch, debug_sample)
    args = ["--n_samples", "2", "--html", "true"]
    pred = debug_sample.main(CPU + args + ["--out", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    _script("debug_sample").main(["--cfg", SMOKE] + args + ["--out", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == sorted(
        f"sample_{i:03d}.{e}" for i in range(2) for e in ("html", "png"))
    assert port_out.replace(str(tmp_path / "port"), "X") == jax_out.replace(str(tmp_path / "jax"), "X")

    want, db = _port_sample(2)
    assert torch.equal(pred, want)
    mano = stack_mano_models(M.get_mano_model(None, "right"), M.get_mano_model(None, "left"), "cpu")
    with torch.no_grad():
        j_pred = batch_recover_mano(mano, want, db["shape"], db["hand_side"])[1].numpy()
    pc, jc = rec["port"]["render_sequence_grid"].calls, rec["jax"]["render_sequence_grid"].calls
    assert len(pc) == len(jc) == 2
    for i, ((pa, pk), (ja, jk)) in enumerate(zip(pc, jc)):
        np.testing.assert_array_equal(_np(pa[0]), j_pred[i])  # the sample's joints
        assert np.isfinite(_np(ja[0])).all() and _np(ja[0]).shape == _np(pa[0]).shape
        np.testing.assert_allclose(_np(pk["joints_ref_seq"]), _np(jk["joints_ref_seq"]), rtol=0, atol=1e-5)  # GT
        np.testing.assert_allclose(_np(pk["obj_points_seq"]), _np(jk["obj_points_seq"]), rtol=0, atol=1e-5)
    for (pa, _), (ja, _) in zip(rec["port"]["export_html_viewer"].calls, rec["jax"]["export_html_viewer"].calls):
        np.testing.assert_allclose(_np(pa[1][0]["pos"]), _np(ja[1][0]["pos"]), rtol=0, atol=1e-5)  # GT track


def test_save_cache_dict_matches_the_jax_script(tmp_path, capsys):
    port, jax_p = str(tmp_path / "port" / "c.pkl"), str(tmp_path / "jax" / "c.pkl")
    assert save_cache_dict.main(CPU + ["--out", port, "--commit"]) == 16
    _script("save_cache_dict").main(["--cfg", SMOKE, "--out", jax_p, "--commit"])
    with open(port, "rb") as f:
        got = pickle.load(f)
    with open(jax_p, "rb") as f:
        want = pickle.load(f)
    assert list(got) == list(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for a, b in zip(got[k], want[k]):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                assert a == b, k
    # a dry run writes nothing
    dry = str(tmp_path / "dry" / "c.pkl")
    capsys.readouterr()
    assert save_cache_dict.main(CPU + ["--out", dry]) == 16
    assert not os.path.exists(os.path.dirname(dry)) and capsys.readouterr().out == ""
    # the toolkit branch: the same SystemExit as the JAX script without oakink2_toolkit
    with pytest.raises(SystemExit) as port_exit:
        save_cache_dict.main(CPU + ["--data.synthetic", "false", "--out", dry])
    with pytest.raises(SystemExit) as jax_exit:
        _script("save_cache_dict").main(["--cfg", SMOKE, "--data.synthetic", "false", "--out", dry])
    assert str(port_exit.value) == str(jax_exit.value) and "oakink2_toolkit" in str(port_exit.value)


@pytest.mark.parametrize("launcher", [debug_sample, debug_refine, viz_seg, save_cache_dict])
def test_launchers_raise_without_a_gpu(launcher, tmp_path, monkeypatch):
    """Without a GPU every launcher raises unless told "cpu" (its default
    device is "cuda"), before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--cfg", SMOKE, "--out", str(tmp_path / "out"), "--commit"])
    assert not os.path.exists(tmp_path / "out")
