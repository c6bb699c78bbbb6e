"""The port's PointBERT tower (oakink2_tamf_tpu_torch/models/pointbert.py),
its checkpoint loader and the compute_obj_assets launcher against the JAX
package's (models/pointbert.py, scripts/compute_obj_assets.py), on the CPU.

Weights cross by interop/from_jax.pointbert_state_dict_from_flax, with the
BatchNorm running statistics moved off their init so that eval mode reads
them. Tolerances, float32 on both sides:
- FPS indices: equal; knn: the same index set per centre;
- the embedding at a small config (512 points, 32 groups of 8, depth 2,
  width 48, 2 heads) in eval mode and in train mode at drop_path_rate 0
  (BatchNorm on the batch's statistics): within 1e-5 of JAX's;
- compute_obj_assets at the default config on 2 meshes (1024 points each):
  the clouds equal, the embeddings within 1e-5 of the JAX script's.
"""

import os

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.interop.from_jax import pointbert_state_dict_from_flax
from oakink2_tamf_tpu_torch.launch import compute_obj_assets as COA
from oakink2_tamf_tpu_torch.models import pointbert as PB
from oakink2_tamf_tpu_torch.utils import mesh_io

SMALL = dict(trans_dim=48, depth=2, drop_path_rate=0.0, num_heads=2, group_size=8, num_group=32, encoder_dims=24)
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch single-threaded under pytest-xdist (the workers share the cores)."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(seed: int, B: int = 3, N: int = 512) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, N, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tower():
    """(JAX PointTransformer, its variables as numpy with moved BatchNorm
    statistics, the port's PointTransformer holding the same weights)."""
    import jax
    import jax.numpy as jnp

    from oakink2_tamf_tpu.models import pointbert as JPB

    jm = JPB.PointTransformer(JPB.PointBertConfig(**SMALL))
    v = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(_clouds(0))))
    rng = np.random.default_rng(1)
    for name, c in (("bn1", 128), ("bn2", 512)):
        v["batch_stats"]["encoder"][name] = {"mean": rng.normal(scale=0.1, size=c).astype(np.float32),
                                             "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)}
    pm = PB.PointTransformer(PB.PointBertConfig(**SMALL))
    pm.load_state_dict(pointbert_state_dict_from_flax(v))
    return jm, v, pm


@pytest.mark.parametrize("B,N,S", [(2, 512, 32), (1, 300, 17), (3, 64, 64)])
def test_fps_indices_equal_jax(B, N, S):
    import jax.numpy as jnp

    from oakink2_tamf_tpu.models import pointbert as JPB

    pts = _clouds(B + N, B, N)
    want = np.asarray(JPB.farthest_point_sampling(jnp.asarray(pts), S))
    got = PB.farthest_point_sampling(torch.from_numpy(pts), S)
    assert got.dtype == torch.int64 and got.shape == (B, S)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 0] == 0).all() and all(len(set(r.tolist())) == S for r in got)


def test_knn_index_sets_equal_jax():
    import jax.numpy as jnp

    from oakink2_tamf_tpu.models import pointbert as JPB

    pts = _clouds(5, 2, 512)
    ctr = pts[:, ::16]  # 32 centres on the cloud
    wn, wi = (np.asarray(a) for a in JPB.knn_group(jnp.asarray(pts), jnp.asarray(ctr), 8))
    gn, gi = PB.knn_group(torch.from_numpy(pts), torch.from_numpy(ctr), 8)
    assert gn.shape == (2, 32, 8, 3) and gi.shape == (2, 32, 8)
    for b in range(2):
        for g in range(32):
            assert set(gi[b, g].tolist()) == set(wi[b, g].tolist()), (b, g)
    # the same centre-relative neighbourhoods, as sets of rows
    key = lambda a: np.sort(a.reshape(-1, 8, 3).round(6).view([("", a.dtype)] * 3).ravel().reshape(-1, 8), axis=1)
    np.testing.assert_array_equal(key(gn.numpy()), key(wn))
    np.testing.assert_allclose(gn.numpy()[:, :, 0], 0.0, atol=0)  # each centre is its own nearest point


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_embedding_matches_jax(tower, mode):
    """[B, 2*trans_dim]: eval reads the running statistics, train the
    batch's (drop_path_rate 0, so nothing random)."""
    import jax.numpy as jnp

    jm, v, pm = tower
    pts = _clouds(2)
    if mode == "eval":
        want = np.asarray(jm.apply(v, jnp.asarray(pts), train=False))
    else:
        want, _ = jm.apply(v, jnp.asarray(pts), train=True, mutable=["batch_stats"])
    init = {k: t.clone() for k, t in pm.state_dict().items()}
    pm.train(mode == "train")
    with torch.no_grad():
        got = pm(torch.from_numpy(pts)).numpy()
    pm.load_state_dict(init)  # train mode moved the running statistics
    assert got.shape == (3, 96)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_eval_and_train_differ(tower):
    """The moved running statistics are what eval mode reads."""
    _, _, pm = tower
    init = {k: t.clone() for k, t in pm.state_dict().items()}
    x = torch.from_numpy(_clouds(3))
    with torch.no_grad():
        e = pm.eval()(x)
        t = pm.train()(x)
    pm.load_state_dict(init)
    pm.eval()
    assert float((e - t).abs().max()) > 1e-2


def test_drop_path_is_per_sample_and_rescaled():
    x = torch.ones(4000, 5, 2)
    torch.manual_seed(0)
    y = PB.drop_path(x, 0.25, training=True)
    kept = y[:, 0, 0] != 0
    assert torch.all((y[kept] == 1 / 0.75)) and torch.all(y[~kept] == 0)
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    assert PB.drop_path(x, 0.25, training=False) is x


def test_jax_convert_of_the_port_state_dict_round_trips(tower):
    """JAX's convert_pointbert_state_dict of the port's state_dict gives the
    variables that the port's weights came from, bit for bit."""
    import jax

    from oakink2_tamf_tpu.models import pointbert as JPB

    _, v, pm = tower
    back = JPB.convert_pointbert_state_dict({k: t.numpy() for k, t in pm.state_dict().items()},
                                            JPB.PointBertConfig(**SMALL))
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0], jax.tree.leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def test_default_config_is_the_jax_packages():
    import dataclasses

    from oakink2_tamf_tpu.models import pointbert as JPB

    assert dataclasses.asdict(PB.PointBertConfig()) == dataclasses.asdict(JPB.PointBertConfig())


def test_state_dict_keys_are_the_references(tower):
    _, _, pm = tower
    keys = set(pm.state_dict())
    for k in ("encoder.first_conv.0.weight", "encoder.first_conv.1.running_var", "encoder.second_conv.3.bias",
              "reduce_dim.weight", "cls_token", "cls_pos", "pos_embed.0.weight", "pos_embed.2.bias",
              "blocks.blocks.1.attn.qkv.weight", "blocks.blocks.0.attn.proj.bias", "blocks.blocks.1.mlp.fc2.weight",
              "blocks.blocks.0.norm2.weight", "norm.bias"):
        assert k in keys, k
    assert "blocks.blocks.0.attn.qkv.bias" not in keys
    assert pm.state_dict()["encoder.first_conv.0.weight"].shape == (128, 3, 1)


def _reference_checkpoint(pm, path, prefix="module.point_encoder."):
    """A reference-layout .pt: {"state_dict": prefixed tensors plus one
    non-tensor entry and one key of another tower}."""
    sd = {prefix + k: t.clone() for k, t in pm.state_dict().items()}
    sd[prefix + "note"] = "not a tensor"
    sd["module.text_encoder.weight"] = torch.zeros(2)
    torch.save({"state_dict": sd, "epoch": 3}, path)


@pytest.mark.parametrize("prefix", ["module.point_encoder.", "point_encoder."])
def test_load_pointbert_checkpoint(tower, tmp_path, prefix):
    _, _, pm = tower
    path = str(tmp_path / "pointbert.pt")
    _reference_checkpoint(pm, path, prefix)
    got = PB.load_pointbert_checkpoint(path, cfg=PB.PointBertConfig(**SMALL))
    for k, t in pm.state_dict().items():
        assert torch.equal(got.state_dict()[k], t), k


def test_load_pointbert_checkpoint_missing_key_raises(tower, tmp_path):
    _, _, pm = tower
    sd = {"module.point_encoder." + k: t for k, t in pm.state_dict().items() if k != "norm.bias"}
    path = str(tmp_path / "short.pt")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="norm.bias"):
        PB.load_pointbert_checkpoint(path, cfg=PB.PointBertConfig(**SMALL))


def test_compute_object_embedding_matches_jax(tower):
    from oakink2_tamf_tpu.models import pointbert as JPB

    _, v, pm = tower
    pts = _clouds(4, 1)[0]
    want = JPB.compute_object_embedding(v, pts, JPB.PointBertConfig(**SMALL))
    pm.train()
    got = PB.compute_object_embedding(pm, pts)
    assert pm.training  # restored
    pm.eval()
    assert isinstance(got, np.ndarray) and got.shape == (96,)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


QUAD_BOX = """# a box of quads with texture indices
v -0.03 -0.06 -0.02
v 0.03 -0.06 -0.02
v 0.03 0.06 -0.02
v -0.03 0.06 -0.02
v -0.03 -0.06 0.02
v 0.03 -0.06 0.02
v 0.03 0.06 0.02
v -0.03 0.06 0.02
f 1/1 4/1 3/1 2/1
f 5/1 6/1 7/1 8/1
f 1/1 2/1 6/1 5/1
f 2/1 3/1 7/1 6/1
f 3/1 4/1 8/1 7/1
f 4/1 1/1 5/1 8/1
"""


def _write_meshes(d) -> None:
    """Two boxes: the box toolkit's obj_000 and one of quad faces."""
    from oakink2_tamf_tpu_torch.data.fabricate import BOX_FACES, box_verts

    os.makedirs(d, exist_ok=True)
    mesh_io.save_obj(os.path.join(d, "obj_000.obj"), box_verts("obj_000"), BOX_FACES)
    with open(os.path.join(d, "obj_quad.obj"), "w") as f:
        f.write(QUAD_BOX)
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("not a mesh\n")


@pytest.fixture(scope="module")
def assets_run(tmp_path_factory, tower):
    """The port's and the JAX script's main on the same 2 meshes and the
    same reference-layout checkpoint at the default config, 1024 points."""
    import importlib.util

    root = tmp_path_factory.mktemp("assets")
    mesh_dir = str(root / "meshes")
    _write_meshes(mesh_dir)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        full = PB.PointTransformer(PB.PointBertConfig())
    ckpt = str(root / "pointbert.pt")
    _reference_checkpoint(full, ckpt)
    common = ["--mesh_dir", mesh_dir, "--n_points", "1024", "--pointbert_ckpt", ckpt, "--commit"]
    port = ["--out_pointcloud", str(root / "port_pc"), "--out_embedding", str(root / "port_emb")]
    oids = COA.main(common + port + ["--device", "cpu"])
    spec = importlib.util.spec_from_file_location(
        "jax_compute_obj_assets", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                               "scripts", "compute_obj_assets.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(common + ["--out_pointcloud", str(root / "jax_pc"), "--out_embedding", str(root / "jax_emb")])
    return root, oids, mesh_dir, ckpt


def test_compute_obj_assets_matches_the_jax_script(assets_run):
    root, oids, _, _ = assets_run
    assert oids == ["obj_000", "obj_quad"]
    for oid in oids:
        got = np.load(root / "port_pc" / f"{oid}.npz")["point"]
        want = np.load(root / "jax_pc" / f"{oid}.npz")["point"]
        assert got.dtype == np.float32 and got.shape == (1024, 3)
        np.testing.assert_array_equal(got, want)
        e, w = np.load(root / "port_emb" / f"{oid}.npy"), np.load(root / "jax_emb" / f"{oid}.npy")
        assert e.dtype == np.float32 and e.shape == (768,)
        np.testing.assert_allclose(e, w, rtol=0, atol=ATOL)
    assert sorted(os.listdir(root / "port_emb")) == ["obj_000.npy", "obj_quad.npy"]


def test_compute_obj_assets_batch_of_one_equals_the_batch(assets_run, tmp_path):
    root, _, mesh_dir, ckpt = assets_run
    COA.main(["--mesh_dir", mesh_dir, "--n_points", "1024", "--pointbert_ckpt", ckpt, "--device", "cpu",
              "--batch_size", "1", "--out_pointcloud", str(tmp_path / "pc"), "--out_embedding",
              str(tmp_path / "emb"), "--commit"])
    for oid in ("obj_000", "obj_quad"):
        np.testing.assert_allclose(np.load(tmp_path / "emb" / f"{oid}.npy"), np.load(root / "port_emb" / f"{oid}.npy"),
                                   rtol=0, atol=ATOL)


def test_compute_obj_assets_port_checkpoint_and_dry_run(assets_run, tmp_path, capsys):
    """A port train checkpoint loads through runtime/ckpt and gives the
    same embeddings as the reference-layout file of the same weights;
    without --commit nothing is written; without a checkpoint the
    random-weights warning is printed."""
    from types import SimpleNamespace

    from oakink2_tamf_tpu_torch.runtime.ckpt import save_train_state

    root, _, mesh_dir, ckpt = assets_run
    model = PB.load_pointbert_checkpoint(ckpt)
    opt = torch.optim.AdamW(model.parameters())
    own = save_train_state(str(tmp_path / "save"), 0, SimpleNamespace(step=5, model=model, optimizer=opt))
    out = ["--out_pointcloud", str(tmp_path / "pc"), "--out_embedding", str(tmp_path / "emb")]
    COA.main(["--mesh_dir", mesh_dir, "--n_points", "1024", "--pointbert_ckpt", own, "--device", "cpu",
              "--commit"] + out)
    assert "port checkpoint" in capsys.readouterr().out
    for oid in ("obj_000", "obj_quad"):
        np.testing.assert_array_equal(np.load(tmp_path / "emb" / f"{oid}.npy"), np.load(root / "port_emb" / f"{oid}.npy"))
    dry = ["--out_pointcloud", str(tmp_path / "dry_pc"), "--out_embedding", str(tmp_path / "dry_emb")]
    COA.main(["--mesh_dir", mesh_dir, "--n_points", "1024", "--device", "cpu"] + dry)
    assert "RANDOM-INIT" in capsys.readouterr().out
    assert not (tmp_path / "dry_pc").exists() and not (tmp_path / "dry_emb").exists()


def test_compute_obj_assets_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        COA.main(["--mesh_dir", str(tmp_path)])


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs an NVIDIA GPU")
def test_tower_on_the_card_matches_the_cpu():
    """FPS picks the same points on the card; the embedding agrees within
    1e-4 of its max-abs (TF32 off). No JAX: the card's machine has none."""
    from oakink2_tamf_tpu_torch._device import set_fp32_precision

    set_fp32_precision()
    torch.manual_seed(0)
    pm = PB.PointTransformer(PB.PointBertConfig(**SMALL)).eval()
    pts = torch.from_numpy(_clouds(6))
    idx = PB.farthest_point_sampling(pts, 32)
    assert torch.equal(PB.farthest_point_sampling(pts.cuda(), 32).cpu(), idx)
    with torch.no_grad():
        cpu = pm(pts)
        gpu = pm.cuda()(pts.cuda()).cpu()
    assert float((gpu - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())
