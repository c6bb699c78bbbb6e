"""The G -> R sampling chain of the port against the JAX package: the G
sampler of parallel/train, TamfPipeline's samplers, extract_sample, the
sample launchers and their helpers.

A small JAX TamfPipeline (G and R with 2 layers of width 32, fixed text
features in place of CLIP) gives the weights; the port's modules take them
through interop/from_jax, and the JAX chain's own noise (replayed from its
keys) is fed to the port.
Tolerance: atol 1e-4, as tests/test_torch_serving.py: float32 matmul and
reduction order differs between XLA and PyTorch on the CPU, and the
difference passes through every step of the chain, R's h2o feature and
MANO. The launcher chain (sample_g -> train_r -> sample_r) runs on the CPU
on config/synthetic_smoke.yml. JAX is imported inside the JAX tests: the
card's machine, which runs this file's cuda tests, has none.
"""

import dataclasses
import logging
import os
import pickle
import zlib

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments, synthetic_batch
from oakink2_tamf_tpu_torch.launch import common, sample_g, sample_r, train_r
from oakink2_tamf_tpu_torch.models import extract_sample as ES
from oakink2_tamf_tpu_torch.models.clip_text import FrozenClipText
from oakink2_tamf_tpu_torch.models.mdm_g import InteractionSegmentMDM, MDMConfig
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime.ckpt import save_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config/synthetic_smoke.yml")
ATOL = 1e-4
SMALL = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=2, dropout=0.0)
SHAPES = dict(batch_size=2, seq_len=16, max_nobj=2, n_obj_points=64)
STEPS = 6
WINDOW, TOL = 4, 1e-2
SAMPLERS = ("ddpm", "ddim", "plms", "parallel")
COND_KEYS = ("pose_repr", "mask", "shape", "hand_side", "text_emb", "obj_traj", "obj_embedding", "obj_mask")


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


class _TextFeatures:
    """A stand-in for CLIP's text tower (tests/test_torch_serving.py holds
    the real one to JAX): fixed features per prompt, numpy for the JAX
    package, tensors for the port."""

    def __init__(self, torch_out: bool):
        self.torch_out = torch_out

    def encode_text(self, texts):
        f = np.stack([np.random.default_rng(zlib.crc32(t.encode())).normal(size=512) for t in texts])
        f = f.astype(np.float32)
        return torch.from_numpy(f) if self.torch_out else f


@pytest.fixture(scope="module")
def pipes():
    """(JAX pipeline, port pipeline) with the same G and R weights."""
    import jax

    from oakink2_tamf_tpu.core import diffusion as JD
    from oakink2_tamf_tpu.core import mano as JM
    from oakink2_tamf_tpu.models.mdm_g import InteractionSegmentMDM as JG
    from oakink2_tamf_tpu.models.mdm_g import MDMConfig as JMDMConfig
    from oakink2_tamf_tpu.models.refine_r import RefineConfig as JRefineConfig
    from oakink2_tamf_tpu.models.refine_r import SegmentRefineNet as JR
    from oakink2_tamf_tpu.models.refine_r import stack_mano_models as jstack
    from oakink2_tamf_tpu.parallel.train import g_cond_from_batch as jcond
    from oakink2_tamf_tpu.serving import TamfPipeline as JTamfPipeline
    from oakink2_tamf_tpu_torch.interop import from_jax
    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig, SegmentRefineNet, stack_mano_models
    from oakink2_tamf_tpu_torch.serving import TamfPipeline

    probe = _cond_batch()
    g_model, refine_net = JG(JMDMConfig(**SMALL)), JR(JRefineConfig(**SMALL))
    g_params = g_model.init(jax.random.PRNGKey(0), probe["pose_repr"], np.zeros((2,), np.int32), jcond(probe))
    rcond = {k: probe[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    r_params = refine_net.init(jax.random.PRNGKey(1), probe["pose_repr"], np.zeros((2, 16, 778), np.float32),
                               rcond)
    common_kw = dict(parallel_window=WINDOW, parallel_tol=TOL, **SHAPES)
    jp = JTamfPipeline(g_model=g_model, g_params=g_params, refine_net=refine_net, r_params=r_params,
                       sched=JD.tamf_schedule(STEPS),
                       mano_stack=jstack(JM.get_mano_model(None, "right"), JM.get_mano_model(None, "left")),
                       clip=_TextFeatures(False), **common_kw)
    g, r = InteractionSegmentMDM(MDMConfig(**SMALL)), SegmentRefineNet(RefineConfig(**SMALL))
    g.load_state_dict(from_jax.g_state_dict_from_flax(_np_tree(g_params)))
    r.load_state_dict(from_jax.r_state_dict_from_flax(_np_tree(r_params)))
    tp = TamfPipeline(g_model=g.eval().requires_grad_(False), refine_net=r.eval().requires_grad_(False),
                      sched=D.tamf_schedule(STEPS),
                      mano_stack=stack_mano_models(M.get_mano_model(None, "right"),
                                                   M.get_mano_model(None, "left"), "cpu"),
                      clip=_TextFeatures(True), device=torch.device("cpu"), **common_kw)
    return jp, tp


def _jax_noise(sampler, key, shape, T=STEPS):
    """The port's noise keywords for what the JAX sampler draws from `key`."""
    import jax
    import jax.numpy as jnp

    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    key, k_init = jax.random.split(key)
    out = {"noise": t(jax.random.normal(k_init, shape, jnp.float32))}
    if sampler == "ddpm":
        out["step_noise"] = t(np.stack([jax.random.normal(k, shape, jnp.float32)
                                        for k in jax.random.split(key, T)]))
    elif sampler == "parallel":
        out["t_noise"] = t(np.stack([jax.random.normal(jax.random.fold_in(key, i), shape, jnp.float32)
                                     for i in range(T)]))
    return out


def _cond_batch(n=2, seed=0):
    """A collated batch of synthetic segments with random text features."""
    segs = [SyntheticSegments(n, seq_len=16, max_nobj=2, n_obj_points=64, seed=seed)[i] for i in range(n)]
    b = SegmentCollate(max_nobj=2, n_obj_points=64)(segs)
    b["text_emb"] = np.random.default_rng(seed).normal(size=(n, 512)).astype(np.float32)
    return {k: b[k] for k in COND_KEYS}


# ---------------------------------------------------------------------------
# make_g_sampler, TamfPipeline(sampler=...)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_make_g_sampler_matches_jax(pipes, sampler):
    import jax

    from oakink2_tamf_tpu.parallel import train as JPT

    jp, tp = pipes
    b = _cond_batch()
    key = jax.random.PRNGKey(3)
    jfn = JPT.make_g_sampler(jp.g_model, jp.sched, sampler=sampler, parallel_window=WINDOW, parallel_tol=TOL)
    want = np.asarray(jfn(jp.g_params, b, key))
    fn = PT.make_g_sampler(tp.sched, sampler=sampler, parallel_window=WINDOW, parallel_tol=TOL)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tp.g_model.train()  # sample_fn runs with dropout off and restores the mode
    got = fn(tp.g_model, tb, None, noise=_jax_noise(sampler, key, want.shape))
    assert tp.g_model.training
    tp.g_model.eval()
    assert tuple(got.shape) == want.shape == (2, 16, 99)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_make_g_sampler_rejects_unknown_sampler(pipes):
    with pytest.raises(ValueError, match="unknown sampler"):
        PT.make_g_sampler(pipes[1].sched, sampler="euler")
    with pytest.raises(ValueError, match="unknown sampler"):
        dataclasses.replace(pipes[1], sampler="euler")


def test_parallel_window_tiles_the_conditioning(pipes):
    """One model call on [W*bs, ...]: each window row sees its own sample's
    conditioning, so the window's rows equal the per-sample calls."""
    _, tp = pipes
    b = {k: torch.from_numpy(v) for k, v in _cond_batch(seed=4).items()}
    fn = PT.g_model_fn(tp.g_model, PT.g_cond_from_batch(b))
    x = torch.randn(3 * 2, 16, 99, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([5, 5, 3, 3, 0, 0])
    with torch.inference_mode():
        whole = fn(x, t)
        parts = torch.cat([fn(x[2 * i : 2 * i + 2], t[2 * i : 2 * i + 2]) for i in range(3)])
    np.testing.assert_allclose(whole.numpy(), parts.numpy(), atol=1e-5)


@pytest.mark.parametrize("sampler", ["ddim", "plms", "parallel"])
def test_pipeline_sampler_matches_jax(pipes, sampler):
    import jax

    jp, tp = pipes
    jp, tp = dataclasses.replace(jp, sampler=sampler), dataclasses.replace(tp, sampler=sampler)
    segs = [SyntheticSegments(3, seq_len=16, max_nobj=2, n_obj_points=64, seed=2)[i] for i in range(3)]
    key = jax.random.PRNGKey(9)
    want = jp.generate(segs, key=key)
    noise = []
    for _ in range(2):  # generate's per-batch `key, k = split(key)`
        key, k = jax.random.split(key)
        noise.append(_jax_noise(sampler, k, (2, 16, 99)))
    got = tp.generate(segs, noise=noise)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("g_sample_pose_repr", "refine_pose_repr", "verts", "joints"):
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# extract_sample
# ---------------------------------------------------------------------------


@pytest.fixture
def jes(monkeypatch):
    """JAX's models/extract_sample, its R forward run under one jax.jit: the
    module calls refine_forward eagerly, op by op, which costs hundreds of
    small XLA compiles on the CPU. The function computed is the same."""
    import jax

    from oakink2_tamf_tpu.models import extract_sample as JES

    eager = JES.refine_forward

    def jitted(net, variables, mano_stack, batch, **kw):
        return jax.jit(lambda v, b: eager(net, v, mano_stack, b, **kw))(variables, batch)

    monkeypatch.setattr(JES, "refine_forward", jitted)
    return JES


@pytest.mark.parametrize("sampler", ["ddpm", "parallel"])
def test_extract_refined_sample_matches_jax(pipes, jes, sampler):
    import jax

    jp, tp = pipes
    segs = [SyntheticSegments(2, seq_len=16, max_nobj=2, n_obj_points=64, seed=5)[i] for i in range(2)]
    key = jax.random.PRNGKey(13)
    want = jes.extract_refined_sample(jp.g_model, jp.g_params, jp.sched, jp.refine_net, jp.r_params,
                                      jp.mano_stack, segs, jp.clip, key, max_nobj=2, n_obj_points=64,
                                      sampler=sampler)
    got = ES.extract_refined_sample(tp.g_model, tp.sched, tp.refine_net, tp.mano_stack, segs, tp.clip,
                                    max_nobj=2, n_obj_points=64, sampler=sampler,
                                    noise=_jax_noise(sampler, key, want.shape))
    assert got.shape == want.shape == (2, 16, 99)
    np.testing.assert_allclose(got, want, atol=ATOL)


def _bimanual_sample(seed=6):
    """A bimanual segment: two hands over three objects, obj_pair giving the
    left hand o2 and o0 and the right hand o1."""
    b = synthetic_batch(np.random.default_rng(seed), batch_size=2, seq_len=16, max_nobj=3, n_obj_points=64)
    m = b["mask"][0]
    return {
        "text": "synthetic bimanual task",
        "len": int(b["len"][0]),
        "mask": m,
        "pose_repr_rh": b["pose_repr"][0],
        "pose_repr_lh": b["pose_repr"][1] * m[:, None],
        "shape_rh": b["shape"][0],
        "shape_lh": b["shape"][1] * m[:, None],
        "obj_list": ["o0", "o1", "o2"],
        "obj_pair": [["o2", "o0"], ["o1"]],
        "obj_traj": b["obj_traj"][0],
        "obj_embedding": b["obj_embedding"][0],
        "obj_pointcloud": b["obj_points"][0],
    }


@pytest.mark.parametrize("hand_side", ["rh", "lh"])
def test_extract_refined_sample_bihand_matches_jax(pipes, jes, hand_side):
    import jax

    jp, tp = pipes
    gt = _bimanual_sample()
    sub, jsub = ES.slice_bihand_sample(gt, hand_side), jes.slice_bihand_sample(gt, hand_side)
    assert set(sub) == set(jsub)
    for k, v in sub.items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(jsub[k]), err_msg=k)
    assert sub["obj_num"] == (1 if hand_side == "rh" else 2)
    key = jax.random.PRNGKey(17)
    want = jes.extract_refined_sample_bihand(jp.g_model, jp.g_params, jp.sched, jp.refine_net, jp.r_params,
                                             jp.mano_stack, gt, hand_side, jp.clip, key, max_nobj=2,
                                             n_obj_points=64)
    got = ES.extract_refined_sample_bihand(tp.g_model, tp.sched, tp.refine_net, tp.mano_stack, gt, hand_side,
                                           tp.clip, max_nobj=2, n_obj_points=64,
                                           noise=_jax_noise("ddpm", key, (1, 16, 99)))
    assert got.shape == want.shape == (16, 99)
    np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# closed_faces, SyntheticSegments, ACTION_LIST, resolve_shard, activation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["right", "left"])
def test_closed_faces_match_jax(side):
    from oakink2_tamf_tpu.core import mano as JM

    got = M.closed_faces(M.synthetic_mano_model(side))
    want = JM.closed_faces(JM.synthetic_mano_model(side))
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > M.synthetic_mano_model(side).faces.shape[0]  # the wrist seal was added


def test_synthetic_segment_keys_match_jax():
    """info, frame_id, obj_list, obj_verts and obj_faces equal the JAX
    package's. Its ACTION_LIST has 69 names for 70 ids, so JAX raises at
    segment 69, where the port takes the first name."""
    from oakink2_tamf_tpu.data.adaptors import ACTION_LIST as JACTIONS
    from oakink2_tamf_tpu.launch.common import SyntheticSegments as JSyntheticSegments
    from oakink2_tamf_tpu_torch.data.adaptors import ACTION_LIST, NUM_ACTIONS

    assert ACTION_LIST == JACTIONS and NUM_ACTIONS == len(JACTIONS) == 69
    port, ref = SyntheticSegments(141, seq_len=20, max_nobj=3), JSyntheticSegments(141, seq_len=20, max_nobj=3)
    for i in (0, 5, 68, 70, 71, 140):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        for k in ("info", "frame_id", "obj_list"):
            assert a[k] == b[k], k
        for k in ("obj_verts", "obj_faces"):
            assert len(a[k]) == len(b[k]) == a["obj_num"]
            for u, v in zip(a[k], b[k]):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
    assert port[71]["info"] == ("synthetic/seq_71", "scoop:0071", "rh")
    with pytest.raises(IndexError):
        ref[69]
    assert port[69]["info"][1] == "cap:0069"


@pytest.mark.parametrize("cfg,want", [
    ({}, (0, 1)),
    ({"num_shards": 0, "shard_index": -1}, (0, 1)),
    ({"num_shards": 3, "shard_index": 2}, (2, 3)),
    ({"num_shards": 2, "shard_index": None}, (0, 2)),
    ({"num_shards": 2, "shard_index": 2}, ValueError),
    ({"shard_index": 1}, ValueError),
])
def test_resolve_shard(cfg, want):
    if want is ValueError:
        with pytest.raises(ValueError, match="out of range"):
            common.resolve_shard(cfg)
    else:
        assert common.resolve_shard(cfg) == want


def test_resolve_shard_follows_the_process_group(monkeypatch):
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert common.resolve_shard({}) == (3, 4)
    assert common.resolve_shard({"num_shards": 8, "shard_index": 5}) == (5, 8)
    with pytest.raises(ValueError):
        common.resolve_shard({"num_shards": 2})  # rank 3 of 2 shards


class _Reg:
    def __init__(self, activation):
        self.activation = activation

    def select(self, name):
        assert name == "model"
        return {"activation": self.activation}


def test_activation_for_checkpoint(tmp_path, caplog):
    """A bare state_dict is a reference checkpoint: gelu_exact, with a
    warning when the config says otherwise. The port's own checkpoint
    keeps the config's activation."""
    net = torch.nn.Linear(2, 2)
    torch.save(net.state_dict(), tmp_path / "ref.pt")
    torch.save({"step": 3, "model": net.state_dict(), "optimizer": {}}, tmp_path / "own.pt")
    assert common.activation_for_checkpoint(_Reg("gelu"), "") is None
    with caplog.at_level(logging.WARNING):
        assert common.activation_for_checkpoint(_Reg("gelu"), str(tmp_path / "ref.pt")) == "gelu_exact"
    assert "forcing activation=gelu_exact" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert common.activation_for_checkpoint(_Reg("gelu_exact"), str(tmp_path / "ref.pt")) == "gelu_exact"
        assert common.activation_for_checkpoint(_Reg("gelu"), str(tmp_path / "own.pt")) is None
    assert "forcing" not in caplog.text


def test_segment_infos_reads_through_adaptors():
    class Store:  # a segment store: aligned info_list and len_list
        info_list = [("a", "x", "rh"), ("b", "y", "lh")]
        len_list = [3, 4]

        def __len__(self):
            return 2

    class Adaptor:
        def __init__(self, base):
            self.base, self.info_list = base, [("dir", 0), ("dir", 1)]

        def __len__(self):
            return 2

    assert common.segment_infos(Adaptor(Store())) == Store.info_list
    ds = SyntheticSegments(3, seq_len=16)
    assert common.segment_infos(ds) == [ds[i]["info"] for i in range(3)]


# ---------------------------------------------------------------------------
# The launchers on the CPU: sample_g -> train_r -> sample_r
# ---------------------------------------------------------------------------


def _save_g_checkpoint(path):
    torch.manual_seed(21)
    g = InteractionSegmentMDM(MDMConfig(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, dropout=0.0))
    torch.save({"step": 0, "model": g.state_dict(), "optimizer": {}}, path)
    return g


def _pkl_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f == "save_dict.pkl":
                out[os.path.relpath(os.path.join(dirpath, f), root)] = os.path.join(dirpath, f)
    return out


def test_cpu_chain_sample_g_train_r_sample_r(tmp_path, monkeypatch):
    """sample_g writes G's samples, train_r trains R on them (through
    GeneratedPoseReprSampleAdaptor) and sample_r refines them with that R,
    on 8 segments of the smoke config."""
    monkeypatch.chdir(tmp_path)
    size = ["--data.synthetic_size", "8"]
    g = _save_g_checkpoint(tmp_path / "g.pt")
    out_dir = sample_g.main(["--cfg", SMOKE, "--runtime.device", "cpu", "--exp_id", "sg", *size,
                             "--sample.split", "train", "--sample.batch_size", "3",
                             "--sample.model_filepath", str(tmp_path / "g.pt"), "--commit"])
    assert out_dir == str(tmp_path / "common" / "sample_g" / "sg" / "sample" / "train" / "sg")
    files = sorted(os.listdir(out_dir))
    assert files == [f"{i:06d}.npy" for i in range(8)]

    # the files are make_g_sampler's output: batches of 3 (the tail padded by
    # repeating its last segment), one generator seeded runtime.seed + shard 0
    ds = SyntheticSegments(8, seq_len=32, max_nobj=2, n_obj_points=128)
    collate = SegmentCollate(max_nobj=2, n_obj_points=128)
    clip = FrozenClipText(device="cpu")
    fn = PT.make_g_sampler(D.tamf_schedule(8))
    gen = torch.Generator().manual_seed(0)
    g.eval()
    want = []
    for start in range(0, 8, 3):
        chunk = list(range(start, min(start + 3, 8)))
        batch = common.attach_text_emb(collate([ds[i] for i in chunk]), clip)
        db = sample_g.pad_batch(common.device_batch(batch, torch.device("cpu")), 3)
        want.append(fn(g, db, gen)[: len(chunk)].numpy())
    want = np.concatenate(want)
    for i, f in enumerate(files):
        a = np.load(os.path.join(out_dir, f))
        assert a.shape == (32, 99) and a.dtype == np.float32
        np.testing.assert_array_equal(a, want[i])
    assert np.abs(want[:, 31]).max() > 0  # raw: padded frames are not zeroed

    state = train_r.main(["--cfg", SMOKE, "--runtime.device", "cpu", "--exp_id", "tr", *size,
                          "--train.num_epoch", "1", "--train.data.pose_repr_sample_dir_list", out_dir])
    assert state.step == 2  # 2 x 8 segments (G samples + perturbed GT), batch 8
    r_ckpt = save_train_state(str(tmp_path / "r"), 0, state)

    out_root = sample_r.main(["--cfg", SMOKE, "--runtime.device", "cpu", "--exp_id", "sr", *size,
                              "--sample.batch_size", "5", "--sample.model_filepath", r_ckpt,
                              "--test.data.pose_repr_sample_dir_list", out_dir, "--commit"])
    assert out_root == str(tmp_path / "common" / "sample_r" / "sr" / "sample" / "sr")
    tree = _pkl_tree(out_root)
    assert len(tree) == 8
    seg = ds[3]
    with open(tree[os.path.join("synthetic++seq_3", "wipe:0003", "rh", "save_dict.pkl")], "rb") as f:
        d = pickle.load(f)
    assert set(d) == {"process_key", "info", "hand_side", "joints", "verts", "faces", "obj_list", "len",
                      "frame_id", "refine_pose_repr"}
    assert d["info"] == seg["info"] and d["process_key"] == "synthetic/seq_3"
    assert d["hand_side"] == "lh" and d["len"] == seg["len"] and d["frame_id"] == seg["frame_id"]
    assert d["obj_list"] == seg["obj_list"]
    assert d["verts"].shape == (32, 778, 3) and d["joints"].shape == (32, 21, 3)
    assert d["refine_pose_repr"].shape == (32, 99)
    np.testing.assert_array_equal(d["faces"], M.closed_faces(M.synthetic_mano_model("left")))
    assert all(np.isfinite(d[k]).all() for k in ("verts", "joints", "refine_pose_repr"))


def test_sample_r_two_shards_disjoint_and_complete(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trees = []
    for w in (0, 1):
        root = sample_r.main(["--cfg", SMOKE, "--runtime.device", "cpu", "--exp_id", f"shard{w}",
                              "--data.synthetic_size", "9", "--sample.num_shards", "2",
                              "--sample.shard_index", str(w), "--commit"])
        trees.append(set(_pkl_tree(root)))
    assert (len(trees[0]), len(trees[1])) == (4, 5)
    assert not trees[0] & trees[1]
    want = {os.path.join(info[0].replace("/", "++"), info[1], info[2], "save_dict.pkl")
            for info in (SyntheticSegments(9, seq_len=32)[i]["info"] for i in range(9))}
    assert trees[0] | trees[1] == want


def test_launchers_write_nothing_without_commit(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--cfg", SMOKE, "--runtime.device", "cpu", "--exp_id", "dry", "--data.synthetic_size", "4"]
    sample_g.main(argv)
    sample_r.main(argv)
    assert not (tmp_path / "common").exists()


# ---------------------------------------------------------------------------
# On the card: make_g_sampler and extract_refined_sample on CUDA against the CPU
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from oakink2_tamf_tpu_torch import _device

    _device.set_fp32_precision()


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_cuda_make_g_sampler_matches_cpu(sampler):
    _cuda_or_skip()
    torch.manual_seed(0)
    g = InteractionSegmentMDM(MDMConfig(**SMALL)).eval()
    b = {k: torch.from_numpy(v) for k, v in _cond_batch().items()}
    gen = torch.Generator().manual_seed(1)
    noise = {"noise": torch.randn(2, 16, 99, generator=gen)}
    if sampler in ("ddpm", "parallel"):
        noise["t_noise" if sampler == "parallel" else "step_noise"] = torch.randn(STEPS, 2, 16, 99, generator=gen)
    sched = D.tamf_schedule(STEPS)
    fn = PT.make_g_sampler(sched, sampler=sampler, parallel_window=WINDOW, parallel_tol=TOL)
    cpu = fn(g, b, None, noise=noise)
    fn_gpu = PT.make_g_sampler(sched.to("cuda"), sampler=sampler, parallel_window=WINDOW, parallel_tol=TOL)
    gpu = fn_gpu(g.cuda(), {k: v.cuda() for k, v in b.items()}, None, noise=noise)
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), atol=1e-3)
