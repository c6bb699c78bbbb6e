"""The training options of the port's trunk and launchers against the JAX
package on the CPU, at small sizes: attention dropout, the bf16 trunk
(`model.compute_dtype`), per-layer activation checkpointing
(`model.remat`), and train_g's profiler trace.

Tolerances:
- attention dropout at 0.5 (N = 2000 draws of one layer's output on each
  side, the port from torch's generator, JAX from flax's): per element,
  the variance ratio port/JAX within [0.7, 1.4] and its mean over the
  elements within 1 +- 0.05; the means within 5 standard errors. The
  ratio of two variance estimates from N draws has a sampling spread of
  about 2/sqrt(N) = 0.045 per element for Gaussian outputs (wider for
  dropout's heavier tails); a layer without attention dropout gives a
  mean ratio of 0.85 and elements down to 0.4;
- bf16 forward and train step, port against JAX at compute_dtype
  "bfloat16": relative RMS error of the output 2e-2, of the loss 1e-2, and
  norm-wise 1e-1 on each parameter's clipped gradient (typically 1-2%; up
  to 5% on attention's packed in-projection bias, whose key third has a
  true gradient of 0 and holds bf16 rounding noise on both sides). The two frameworks round
  at different places (models/trunk.py lists them: the softmax, the GELU
  and the bias add round once in torch and between operations in XLA,
  whose CPU backend may also keep excess precision), so the two bf16
  results lie about as far from each other as each lies from float32
  (~1e-2 relative on these nets). The port's bf16 output must differ from
  its float32 output by more than 1e-3 relative RMS (float32 port and JAX
  agree to ~1e-6), so a trunk that ignores compute_dtype fails; the dtype
  checks (bf16 matmul operands inside the trunk, float32 out of it, into
  the head and into the extra loss) fail a trunk whose bf16 is mis-scoped;
- the extra-loss terms of a bf16 step against the float32 extra loss on
  the same model output: rtol 1e-5;
- remat against no remat at dropout 0.1, the same seed: loss and every
  gradient within 1e-6 (the same ops on the same masks).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from oakink2_tamf_tpu.core import diffusion as JD
from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.data.synthetic import synthetic_batch, with_perturbed_sample
from oakink2_tamf_tpu.models import losses as JLL
from oakink2_tamf_tpu.models import mdm_g as JMDM
from oakink2_tamf_tpu.models import refine_r as JR
from oakink2_tamf_tpu.models import trunk as JT
from oakink2_tamf_tpu.parallel import train as JPT
from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.launch import sample_g, sample_r, train_g, train_r
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import mdm_g as MDM
from oakink2_tamf_tpu_torch.models import refine_r as R
from oakink2_tamf_tpu_torch.models import trunk as TT
from oakink2_tamf_tpu_torch.parallel import train as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config/synthetic_smoke.yml")
SMALL = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, dropout=0.0)
BF16 = dict(SMALL, compute_dtype="bfloat16")
R_KEYS = ("pose_repr", "sample_pose_repr", "mask", "shape", "hand_side", "obj_traj",
          "obj_embedding", "obj_mask", "obj_points")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel_rms(a, b) -> float:
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _jtree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Attention dropout
# ---------------------------------------------------------------------------


def test_attention_dropout_variance_matches_jax():
    """One layer at dropout 0.5 in train mode, the same weights: the spread
    of its output over 2000 draws is JAX's, whose attention drops its
    softmax weights with one mask per call."""
    d, n_draws = 16, 2000
    x = np.random.default_rng(0).normal(size=(2, 6, d)).astype(np.float32)
    jm = JT.TransformerEncoder(d_model=d, num_heads=4, ff_size=32, num_layers=1, dropout=0.5)
    params = _jtree(jm.init(jax.random.PRNGKey(0), x))
    apply = jax.jit(jax.vmap(lambda k: jm.apply(params, x, deterministic=False, rngs={"dropout": k})))
    want = np.asarray(apply(jax.random.split(jax.random.PRNGKey(1), n_draws)))
    pm = TT.TransformerEncoder(d, 4, 32, 1, 0.5)
    pm.load_state_dict({k[2:]: v for k, v in from_jax._trunk(params["params"], "x").items()})
    pm.train()
    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # 2000 calls of a few tiny ops: more threads only contend
    try:
        with torch.no_grad():
            got = np.stack([pm(_t(x)).numpy() for _ in range(n_draws)])
    finally:
        torch.set_num_threads(threads)
    ratio = got.var(0) / want.var(0)
    assert 0.95 <= ratio.mean() <= 1.05, ratio.mean()
    assert 0.7 <= ratio.min() and ratio.max() <= 1.4, (ratio.min(), ratio.max())
    stderr = np.sqrt((got.var(0) + want.var(0)) / n_draws)
    assert np.all(np.abs(got.mean(0) - want.mean(0)) <= 5 * stderr)


def test_attention_dropout_mask_is_shared_by_batch_and_heads():
    """Two equal samples and two heads with the same projections: in train
    mode every sample and head sees one mask, so their outputs stay equal;
    some weights were dropped; eval mode is the dropout-free attention."""
    d, h = 8, 2
    att = TT.SelfAttention(d, h, dropout=0.5)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        blocks = [torch.randn(d // h, d, generator=g) for _ in range(3)]  # q, k, v of one head
        att.in_proj_weight.copy_(torch.cat([b.repeat(h, 1) for b in blocks]))
        att.in_proj_bias.zero_()
        att.out_proj.weight.copy_(torch.eye(d))
    x = torch.randn(1, 5, d, generator=g).repeat(2, 1, 1)
    off = TT.SelfAttention(d, h, dropout=0.0)
    off.load_state_dict(att.state_dict())
    with torch.no_grad():
        want = off(x)
        att.eval()
        assert torch.equal(att(x), want)
        att.train()
        torch.manual_seed(3)
        got = att(x)
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[..., : d // h], got[..., d // h:])
    assert not torch.allclose(got, want)


# ---------------------------------------------------------------------------
# bf16 trunk
# ---------------------------------------------------------------------------


class _TrunkDtypes(TorchFunctionMode):
    """Records the operand dtypes of every linear and matmul."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("linear", "matmul", "__matmul__"):
            self.seen.append(tuple(a.dtype for a in args if isinstance(a, torch.Tensor)))
        return func(*args, **(kwargs or {}))


def _watch_dtypes(model):
    """Hooks that record the trunk's matmul operand dtypes, its output dtype
    and the head's input dtype."""
    rec, mode = {}, _TrunkDtypes()
    def trunk_in(m, a):
        mode.__enter__()

    def trunk_out(m, a, out):
        mode.__exit__(None, None, None)
        rec["trunk_out"] = out.dtype

    model.seqTransEncoder.register_forward_pre_hook(trunk_in)
    model.seqTransEncoder.register_forward_hook(trunk_out)
    model.output_process.register_forward_pre_hook(lambda m, a: rec.__setitem__("head_in", a[0].dtype))
    rec["matmuls"] = mode.seen
    return rec


def _cond(rng, bs=2, L=10):
    return {
        "text_emb": rng.normal(size=(bs, 512)).astype(np.float32),
        "hand_side": np.array([0, 1])[:bs].astype(np.int32),
        "shape": rng.normal(size=(bs, L, 10)).astype(np.float32),
        "obj_traj": rng.normal(size=(bs, 2, L, 9)).astype(np.float32),
        "obj_embedding": rng.normal(size=(bs, 2, 768)).astype(np.float32),
        "obj_mask": np.array([[True, False], [True, True]])[:bs],
    }


def _tcond(c):
    out = {k: _t(v) for k, v in c.items()}
    out["hand_side"] = out["hand_side"].long()
    return out


@pytest.mark.parametrize("net", ["G", "R"])
def test_bf16_forward_matches_jax(net):
    rng = np.random.default_rng(1)
    c = _cond(rng)
    x = rng.normal(size=(2, 10, 99)).astype(np.float32)
    if net == "G":
        second = np.array([3, 999])
        jcls, jcfg = JMDM.InteractionSegmentMDM, JMDM.MDMConfig
        cls, cfg, convert = MDM.InteractionSegmentMDM, MDM.MDMConfig, from_jax.g_state_dict_from_flax
    else:
        del c["text_emb"]
        second = rng.uniform(size=(2, 10, 778)).astype(np.float32)
        jcls, jcfg = JR.SegmentRefineNet, JR.RefineConfig
        cls, cfg, convert = R.SegmentRefineNet, R.RefineConfig, from_jax.r_state_dict_from_flax
    params = _jtree(jax.jit(jcls(jcfg(**SMALL)).init)(jax.random.PRNGKey(0), x, second, c))
    got, want = {}, {}
    for dtype in ("bfloat16", "float32"):
        want[dtype] = jax.jit(jcls(jcfg(**dict(SMALL, compute_dtype=dtype))).apply)(params, x, second, c)
        pm = cls(cfg(**dict(SMALL, compute_dtype=dtype))).eval()
        pm.load_state_dict(convert(params))
        rec = _watch_dtypes(pm)
        with torch.no_grad():
            got[dtype] = pm(_t(x), _t(second), _tcond(c))
        assert got[dtype].dtype == torch.float32
        assert rec["trunk_out"] == torch.float32 and rec["head_in"] == torch.float32
        # per layer: the in-projection, q k^T, @ v, the out-projection, linear1, linear2
        assert len(rec["matmuls"]) == 6 * SMALL["num_layers"]
        assert all(d == getattr(torch, dtype) for ops in rec["matmuls"] for d in ops), rec["matmuls"]
        assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert _rel_rms(got["float32"], want["float32"]) < 1e-5
    assert _rel_rms(got["bfloat16"], want["bfloat16"]) <= 2e-2
    assert _rel_rms(got["bfloat16"], got["float32"]) > 1e-3
    print(f"{net}: bf16 vs JAX bf16 {_rel_rms(got['bfloat16'], want['bfloat16']):.3e}, "
          f"bf16 vs f32 {_rel_rms(got['bfloat16'], got['float32']):.3e}, "
          f"JAX bf16 vs f32 {_rel_rms(want['bfloat16'], want['float32']):.3e}")


def test_compute_dtype_choices_and_devices(monkeypatch):
    with pytest.raises(ValueError, match="compute_dtype 'float16'"):
        MDM.InteractionSegmentMDM(MDM.MDMConfig(**dict(SMALL, compute_dtype="float16")))
    with pytest.raises(ValueError, match="not in"):
        train_g.main(["--cfg", SMOKE, "--runtime.device", "cpu", "--model.compute_dtype", "float16"])
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (7, 5))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "an sm_75 card")
    with pytest.raises(RuntimeError, match="cannot run bfloat16"):
        TT._check_bf16_device.__wrapped__(torch.device("cuda"))
    TT._check_bf16_device.__wrapped__(torch.device("cpu"))


def _mano_pair():
    return (JR.stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left")),
            R.stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu"))


def _capture():
    """An optax optimizer that returns zero updates and keeps the gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))


def _grads_close(model, jgrads, convert, tol):
    """The port's gradients, clipped by its optimizer step, against JAX's
    clipped the same way (per parameter to norm 0.1)."""
    jclipped, _ = JPT.per_param_clip(0.1).update(jgrads, None)
    want = {k: v.numpy() for k, v in convert(_jtree(jclipped)).items()}
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in got:
        assert np.linalg.norm(got[k] - want[k]) <= tol * np.linalg.norm(want[k]) + 1e-6, k


def test_bf16_g_train_step_matches_jax():
    """One bf16 G step (composed route) against JAX make_g_train_step at
    compute_dtype bfloat16: the same weights, batch, t and noise. The extra
    loss runs in float32 on the model's float32 output."""
    rng = np.random.default_rng(3)
    batch = synthetic_batch(rng, batch_size=2, seq_len=8, max_nobj=2, n_obj_points=64, min_len=5, as_jax=False)
    batch["t"] = np.array([3, 41], np.int32)
    batch["t_weights"] = np.array([1.0, 0.5], np.float32)
    jmodel = JMDM.InteractionSegmentMDM(JMDM.MDMConfig(**BF16))
    params = _jtree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch["pose_repr"], np.zeros((2,), np.int32),
                                         JPT.g_cond_from_batch(batch)))
    jmano, mano = _mano_pair()
    jstep = JPT.make_g_train_step(jmodel, JD.tamf_schedule(50), _capture(), jmano, JLL.load_contact_assets(),
                                  JLL.ExtraLossConfig(), chunk=64, mesh=None, dist_impl="composed")
    key = jax.random.PRNGKey(5)
    jstate, jmetrics = jstep(JPT.init_train_state(jax.tree.map(jnp.asarray, params), _capture()),
                             {k: jnp.asarray(v) for k, v in batch.items()}, key)
    noise = np.asarray(jax.random.normal(jax.random.split(key, 4)[1], batch["pose_repr"].shape, jnp.float32))

    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**BF16))
    model.load_state_dict(from_jax.g_state_dict_from_flax(params))
    outputs = []
    model.register_forward_hook(lambda m, a, out: outputs.append(out.detach()))
    state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
    assets, extra_cfg = LL.load_contact_assets(), LL.ExtraLossConfig()
    step = PT.make_g_train_step(D.tamf_schedule(50), mano, assets, extra_cfg, dist_impl="composed")
    tb = {k: _t(v) for k, v in batch.items()}
    metrics = step(state, tb, noise=_t(noise))
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-2 * abs(float(jmetrics["loss"]))
    _grads_close(model, jstate.opt_state, from_jax.g_state_dict_from_flax, 1e-1)
    (out,) = outputs
    assert out.dtype == torch.float32
    _, terms = LL.interaction_segment_extra_loss(mano, assets, extra_cfg, out, tb, dist_impl="composed")
    for k, v in terms.items():
        np.testing.assert_allclose(float(metrics[f"extra/{k}"]), float(v), rtol=1e-5, err_msg=k)


def test_bf16_r_train_step_matches_jax():
    """One bf16 R step against JAX make_r_train_step at compute_dtype
    bfloat16; its loss terms equal the float32 refine loss on the net's
    float32 output."""
    rng = np.random.default_rng(4)
    b = synthetic_batch(rng, batch_size=2, seq_len=8, max_nobj=2, n_obj_points=64, min_len=5, as_jax=False)
    b = with_perturbed_sample(b, rng)
    b = {k: np.asarray(b[k]) for k in R_KEYS}
    jnet = JR.SegmentRefineNet(JR.RefineConfig(**BF16))
    cond = {k: b[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}
    params = _jtree(jax.jit(jnet.init)(jax.random.PRNGKey(0), b["sample_pose_repr"],
                                       np.zeros(b["mask"].shape + (778,), np.float32), cond))
    jmano, mano = _mano_pair()
    jstep = JPT.make_r_train_step(jnet, _capture(), jmano, JLL.load_contact_assets(), JLL.RefineLossConfig(),
                                  chunk=64, mesh=None)
    jstate, jm = jstep(JPT.init_train_state(jax.tree.map(jnp.asarray, params), _capture()),
                       {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))

    net = R.SegmentRefineNet(R.RefineConfig(**BF16))
    net.load_state_dict(from_jax.r_state_dict_from_flax(params))
    outputs = []
    net.register_forward_hook(lambda m, a, out: outputs.append(out.detach()))
    state = PT.TrainState(net, PT.make_optimizer(net.named_parameters()))
    assets, loss_cfg = LL.load_contact_assets(), LL.RefineLossConfig()
    tb = {k: _t(v) for k, v in b.items()}
    metrics = PT.make_r_train_step(mano, assets, loss_cfg)(state, tb)
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-2 * abs(float(jm["loss"]))
    _grads_close(net, jstate.opt_state, from_jax.r_state_dict_from_flax, 1e-1)
    (out,) = outputs
    assert out.dtype == torch.float32

    class Fixed(torch.nn.Module):
        def forward(self, *args):
            return out

    with torch.no_grad():
        got = R.refine_forward(Fixed(), mano, tb, loss_frame_mask=tb["mask"])
    _, terms = LL.segment_refine_loss(assets, loss_cfg, got, tb)
    for k, v in terms.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_equals_no_remat_and_runs_each_layer_twice(compute_dtype):
    """A G step at dropout 0.1 with and without remat from the same seed:
    the recomputed forward draws the same dropout masks (the attention's
    too), so loss and gradients agree; each layer's forward runs twice
    with remat and once without, and once under no_grad either way."""
    rng = np.random.default_rng(5)
    batch = {k: _t(v) for k, v in synthetic_batch(rng, batch_size=2, seq_len=8, max_nobj=2, n_obj_points=64,
                                                   min_len=5, as_jax=False).items()}
    batch["t"], batch["t_weights"] = torch.tensor([3, 41]), torch.ones(2)
    _, mano = _mano_pair()
    cfg = dict(SMALL, dropout=0.1, compute_dtype=compute_dtype)
    res = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = MDM.InteractionSegmentMDM(MDM.MDMConfig(remat=remat, **cfg))
        calls = [0] * len(model.seqTransEncoder.layers)
        for i, layer in enumerate(model.seqTransEncoder.layers):
            layer.register_forward_pre_hook(lambda m, a, i=i: calls.__setitem__(i, calls[i] + 1))
        state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
        step = PT.make_g_train_step(D.tamf_schedule(50), mano, LL.load_contact_assets(), LL.ExtraLossConfig())
        torch.manual_seed(1)
        m = step(state, batch, noise=torch.zeros_like(batch["pose_repr"]) + 0.3)
        assert calls == [2 if remat else 1] * len(calls)
        with torch.no_grad():
            model(batch["pose_repr"], batch["t"], PT.g_cond_from_batch(batch))
        assert calls == [3 if remat else 2] * len(calls)
        res[remat] = (float(m["loss"]), {k: p.grad.clone() for k, p in model.named_parameters()})
    assert abs(res[True][0] - res[False][0]) <= 1e-6 * abs(res[False][0])
    for k, g in res[False][1].items():
        torch.testing.assert_close(res[True][1][k], g, rtol=1e-6, atol=1e-6, msg=k)


# ---------------------------------------------------------------------------
# The launchers and the profiler
# ---------------------------------------------------------------------------


def test_launchers_take_bf16_and_remat(tmp_path, monkeypatch):
    """train_g (bf16 + remat) writes a checkpoint that sample_g loads at
    bf16; train_r (bf16 + remat) and sample_r at bf16 on sample_g's output."""
    monkeypatch.chdir(tmp_path)
    base = ["--cfg", SMOKE, "--runtime.device", "cpu", "--runtime.num_worker", "0", "--data.synthetic_size", "4",
            "--data.synthetic_seq_len", "16", "--model.compute_dtype", "bfloat16"]
    train = ["--model.remat", "true", "--train.num_epoch", "1", "--train.batch_size", "2"]
    state = train_g.main(base + train + ["--exp_id", "tg", "--commit"])
    assert state.step == 2 and state.model.cfg.remat and state.model.cfg.compute_dtype == "bfloat16"
    ckpt = tmp_path / "common" / "train_g" / "tg" / "save" / "model_0000.pt"
    out_dir = sample_g.main(base + ["--exp_id", "sg", "--sample.model_filepath", str(ckpt), "--commit"])
    samples = [np.load(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))]
    assert len(samples) == 4 and all(np.isfinite(s).all() for s in samples)
    state = train_r.main(base + train + ["--exp_id", "tr", "--train.data.cache_target_h2o", "false"])
    assert state.step == 2 and state.model.cfg.remat and state.model.cfg.compute_dtype == "bfloat16"
    out_root = sample_r.main(base + ["--exp_id", "sr", "--test.data.pose_repr_sample_dir_list", out_dir, "--commit"])
    assert sum(len(f) for _, _, f in os.walk(out_root)) == 4


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_train_g_profile_trace(tmp_path, monkeypatch, caplog):
    """The trace spans steps 11-20. With the span moved to steps 2-3 (to
    keep the test short): TAMF_PROFILE_DIR traces a 4-step run, stopping
    after step 3; runtime.profile_dir on a 2-step run, which ends inside
    the span, still writes its trace. Each trace parses and holds the
    step's operators and the program's spans (runtime/profiler.span)."""
    assert train_g.PROFILE_SPAN == (10, 20)
    monkeypatch.setattr(train_g, "PROFILE_SPAN", (1, 3))
    monkeypatch.chdir(tmp_path)
    base = ["--cfg", SMOKE, "--runtime.device", "cpu", "--runtime.num_worker", "0", "--model.num_layers", "1",
            "--data.synthetic_size", "4", "--data.synthetic_seq_len", "16", "--train.batch_size", "2"]
    monkeypatch.setenv("TAMF_PROFILE_DIR", str(tmp_path / "env"))
    with caplog.at_level("INFO", logger=train_g.__name__):
        assert train_g.main(base + ["--train.num_epoch", "2"]).step == 4
        monkeypatch.delenv("TAMF_PROFILE_DIR")
        assert train_g.main(base + ["--train.num_epoch", "1", "--runtime.profile_dir", str(tmp_path / "flag")]).step == 2
    logged = [r.getMessage() for r in caplog.records if "profiler trace" in r.getMessage()]
    assert logged[0].startswith("profiler trace (steps 2-3) -> " + str(tmp_path / "env"))
    assert logged[1].startswith("profiler trace (steps 2-2) -> " + str(tmp_path / "flag"))
    for sub in ("env", "flag"):
        (name,) = os.listdir(tmp_path / sub)
        events = _trace_events(tmp_path / sub / name)
        assert any(e.get("name", "").startswith("aten::") for e in events), sub
        names = {e.get("name") for e in events}
        assert {"train.g_step", "mano.recover"} <= names, sub
