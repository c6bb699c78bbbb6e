"""The JAX package's checkpoint file in the port (interop/from_jax,
interop/to_jax, runtime/ckpt): a `.ckpt` written by the JAX package's own
save_train_state, for G, R and the FID encoder at config/synthetic_smoke.yml's
widths after two updates of its make_optimizer(milestones_steps=[1, 3]) on
gradients drawn from a numpy seed, read by the port's loaders and entry
points; and the port's save_checkpoint read back by the JAX package's
load_checkpoint.

Tolerances: after a load the weights, the AdamW moments, the step and the
learning rate are equal bit for bit (the converters only rearrange); the
next two updates on the same gradients rtol 1e-6 (tests/test_torch_train_g.py's
optax comparison) with atol 1e-5 x base_lr: optax evaluates Adam's bias
correction 1 - 0.999^t in float32, off by up to 2e-5 of itself at t <= 4
(0.999 itself rounds), 1e-5 after the square root, on updates of about lr
per element, where torch evaluates it in float64; rtol alone cannot hold on
elements that an update brings near 0. The round trip is bit for bit; a
loaded net's forward against JAX's model.apply on the file's params atol
2e-5 (tests/test_torch_models.py's transformer forwards).

The entry points' nets are held against model.apply on the params
unflattened from the file, not against a JAX sampler's output: the JAX
samplers load a `.ckpt` into a params target (load_checkpoint(fp, params,
strict=False)), whose keys params/... miss the file's 1/params/..., so they
keep their random weights.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oakink2_tamf_tpu.models import encoder as JE
from oakink2_tamf_tpu.models import mdm_g as JMDM
from oakink2_tamf_tpu.models import refine_r as JR
from oakink2_tamf_tpu.parallel import train as JPT
from oakink2_tamf_tpu.runtime import ckpt as JC
from oakink2_tamf_tpu_torch.eval import compute_score as CS
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.launch import (
    common, debug_refine, debug_sample, sample_g, sample_r, train_encoder, train_g, train_r,
)
from oakink2_tamf_tpu_torch.models.encoder import EncoderConfig, SegmentEncoder
from oakink2_tamf_tpu_torch.models.mdm_g import InteractionSegmentMDM, MDMConfig
from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig, SegmentRefineNet
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime.ckpt import load_checkpoint, load_model_weights, save_checkpoint
from oakink2_tamf_tpu_torch.serving import TamfPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config", "synthetic_smoke.yml")
CPU = ["--cfg", SMOKE, "--runtime.device", "cpu"]
WIDTHS = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, dropout=0.0)  # the smoke config's model
KINDS = ("g", "r", "encoder")
BASE_LR = 1e-2
ATOL_NET = 2e-5

JAX_MODELS = {
    "g": lambda act="gelu": JMDM.InteractionSegmentMDM(JMDM.MDMConfig(activation=act, **WIDTHS)),
    "r": lambda act="gelu": JR.SegmentRefineNet(JR.RefineConfig(activation=act, **WIDTHS)),
    "encoder": lambda act="gelu": JE.SegmentEncoder(JE.EncoderConfig(activation=act, **WIDTHS)),
}
PORT_MODELS = {
    "g": lambda: InteractionSegmentMDM(MDMConfig(**WIDTHS)),
    "r": lambda: SegmentRefineNet(RefineConfig(**WIDTHS)),
    "encoder": lambda: SegmentEncoder(EncoderConfig(**WIDTHS)),
}
FROM_FLAX = {"g": from_jax.g_state_dict_from_flax, "r": from_jax.r_state_dict_from_flax,
             "encoder": from_jax.encoder_state_dict_from_flax}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch single-threaded under pytest-xdist, whose workers share the
    cores (tests/test_torch_r_train.py)."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind: str, seed: int) -> tuple:
    """A forward's numpy arguments: G (x, t, cond), R (x, h2o, cond), the
    encoder (pose_repr, cond)."""
    rng = np.random.default_rng(seed)
    bs, L, nobj = 2, 10, 2
    cond = {
        "text_emb": rng.normal(size=(bs, 512)).astype(np.float32),
        "hand_side": np.array([0, 1], np.int32),
        "shape": rng.normal(size=(bs, L, 10)).astype(np.float32),
        "obj_traj": rng.normal(size=(bs, nobj, L, 9)).astype(np.float32),
        "obj_embedding": rng.normal(size=(bs, nobj, 768)).astype(np.float32),
        "obj_mask": np.array([[True, False], [True, True]]),
    }
    x = rng.normal(size=(bs, L, 99)).astype(np.float32)
    if kind == "g":
        return x, np.array([3, 7], np.int32), cond
    del cond["text_emb"]
    if kind == "r":
        return x, rng.uniform(size=(bs, L, 778)).astype(np.float32), cond
    return x, cond


def _torch_args(args: tuple) -> list:
    out = []
    for a in args:
        if isinstance(a, dict):
            a = {k: torch.from_numpy(v) for k, v in a.items()}
            a["hand_side"] = a["hand_side"].long()
            out.append(a)
        else:
            out.append(torch.from_numpy(a))
    return out


def _assert_forward_matches(kind: str, net: torch.nn.Module, variables, activation: str = "gelu") -> None:
    """`net`'s forward equals JAX's model.apply(variables) at `activation`."""
    args = _inputs(kind, 5)
    jm = JAX_MODELS[kind](activation)
    kw = {} if kind == "encoder" else {"deterministic": True}
    want = jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(variables, *args)
    with torch.no_grad():
        got = net.eval()(*_torch_args(args))
    if kind == "encoder":
        for k in ("encoding", "activation"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL_NET, rtol=0, err_msg=k)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_NET, rtol=0)


def _grads(variables, rng) -> dict:
    """A gradient tree: normal draws for the params, 0 for the encoder's
    buffers (what stop_gradient gives them in the JAX encoder step)."""
    return {c: jax.tree.map(lambda a, c=c: (rng.normal(size=a.shape) if c == "params" else np.zeros(a.shape))
                            .astype(np.float32), sub) for c, sub in variables.items()}


def _jax_updater(opt):
    """One update of the JAX package's optimizer, jitted (one compile per
    tree in place of one per eager op)."""

    @jax.jit
    def update(state, g):
        upd, opt_state = opt.update(g, state.opt_state, state.params)
        return JPT.TrainState(state.step + 1, optax.apply_updates(state.params, upd), opt_state)

    return update


def _port_state(kind: str) -> PT.TrainState:
    model = PORT_MODELS[kind]()
    return PT.TrainState(model, PT.make_optimizer(model.named_parameters(), base_lr=BASE_LR,
                                                  milestones_steps=[1, 3]))


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Per kind: the JAX package's model_0001.ckpt after two updates, its
    TrainState, the update function and the four gradient trees."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    out = {}
    for i, kind in enumerate(KINDS):
        jm = JAX_MODELS[kind]()
        variables = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(i), *_inputs(kind, 0)))
        opt = JPT.make_optimizer(base_lr=BASE_LR, milestones_steps=[1, 3])
        update = _jax_updater(opt)
        rng = np.random.default_rng(10 + i)
        grads = [_grads(variables, rng) for _ in range(4)]
        state = JPT.init_train_state(jax.tree.map(jnp.asarray, variables), opt)
        for g in grads[:2]:
            state = update(state, g)
        state = jax.device_get(state)
        path = JC.save_train_state(str(root / kind), 1, state)
        out[kind] = dict(path=path, state=state, update=update, grads=grads)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_load_restores_weights_moments_step_and_lr(kind, jax_files):
    f = jax_files[kind]
    tree = JC.load_checkpoint(f["path"])  # the JAX package's own reader: the file's nested tree
    conv = FROM_FLAX[kind]
    state = _port_state(kind)
    load_checkpoint(f["path"], state, strict=True)
    model, opt = state.model, state.optimizer
    sd = model.state_dict()
    for k, v in conv(tree["1"]).items():
        assert torch.equal(sd[k], v), k
    mu, nu = conv(tree["2"]["1"]["0"]["mu"]), conv(tree["2"]["1"]["0"]["nu"])
    named = dict(model.named_parameters())
    for n, p in named.items():
        st = opt.adamw.state[p]
        assert torch.equal(st["exp_avg"], mu[n]) and torch.equal(st["exp_avg_sq"], nu[n]), n
        assert float(st["step"]) == 2.0
    assert state.step == 2
    assert opt.lr == BASE_LR * 0.5  # update 3 runs past milestone 1

    # two more updates on the same gradients: the second crosses milestone 3
    jstate, lrs = f["state"], []
    for g in f["grads"][2:]:
        jstate = f["update"](jstate, g)
        tg = conv(g)
        opt.zero_grad()
        for n, p in named.items():
            p.grad = tg[n].clone()
        lrs.append(opt.lr)
        opt.step()
        want = conv(jax.tree.map(np.asarray, jstate.params))
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-5 * BASE_LR,
                                       err_msg=n)
    assert lrs == [BASE_LR * 0.5, BASE_LR * 0.25]


@pytest.mark.parametrize("kind", KINDS)
def test_save_checkpoint_round_trips_through_the_jax_loader(kind, jax_files, tmp_path):
    """JAX state -> .ckpt -> port -> save_checkpoint -> the JAX package's
    load_checkpoint(strict=True) gives every leaf back bit for bit."""
    f = jax_files[kind]
    state = _port_state(kind)
    load_checkpoint(f["path"], state, strict=True)
    out = str(tmp_path / "save" / "model_0001.ckpt")
    save_checkpoint(out, state)
    with open(f["path"], "rb") as a, open(out, "rb") as b:
        assert list(pickle.load(b)) == list(pickle.load(a))  # the same keys in the same order
    back = JC.load_checkpoint(out, f["state"], strict=True)
    got, want = jax.tree.leaves(back), jax.tree.leaves(f["state"])
    assert len(got) == len(want)
    for x, y in zip(got, want):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _capture_loads(monkeypatch, modules) -> list:
    """Record (launcher, module) for each load_model_weights call of the
    given launcher modules (the load itself still runs)."""
    seen = []
    for mod in modules:
        def load(module, path, _real=mod.load_model_weights, _name=mod.__name__.rsplit(".", 1)[-1]):
            _real(module, path)
            seen.append((_name, module))
        monkeypatch.setattr(mod, "load_model_weights", load)
    return seen


def test_launchers_run_a_jax_ckpt_under_the_config_activation(jax_files, tmp_path, monkeypatch):
    """sample_g, sample_r on its samples, compute_score fid on sample_r's
    save_dicts, debug_sample and debug_refine, each given a JAX .ckpt: the
    net each loads runs under the config's activation (gelu) and equals
    JAX's model.apply on the file's params."""
    monkeypatch.chdir(tmp_path)
    seen = _capture_loads(monkeypatch, (sample_g, sample_r, CS, debug_sample, debug_refine))
    size = ["--data.synthetic_size", "4"]
    g, r, enc = (jax_files[k]["path"] for k in KINDS)
    g_dir = sample_g.main([*CPU, *size, "--exp_id", "sg", "--sample.model_filepath", g, "--commit"])
    r_dir = sample_r.main([*CPU, *size, "--exp_id", "sr", "--sample.model_filepath", r, "--commit",
                           "--test.data.pose_repr_sample_dir_list", g_dir])
    res = CS.main(["fid", *CPU, *size, "--score.sample_dir", r_dir, "--score.encoder_filepath", enc])
    assert res["n_segments"] == 4
    debug_sample.main([*CPU, "--model_filepath", g, "--n_samples", "1", "--out", str(tmp_path / "ds")])
    debug_refine.main([*CPU, "--model_filepath", r, "--n_samples", "1", "--out", str(tmp_path / "dr")])
    kinds = {"sample_g": "g", "debug_sample": "g", "sample_r": "r", "debug_refine": "r", "compute_score": "encoder"}
    assert [name for name, _ in seen] == ["sample_g", "sample_r", "compute_score", "debug_sample", "debug_refine"]
    for name, net in seen:
        kind = kinds[name]
        assert net.cfg.activation == "gelu", name
        _assert_forward_matches(kind, net, JC.load_checkpoint(jax_files[kind]["path"])["1"])


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_serving_loads_jax_ckpts_under_its_callers_configs(activation, jax_files):
    g, r = jax_files["g"]["path"], jax_files["r"]["path"]
    pipe = TamfPipeline.load(g, r, g_config=MDMConfig(activation=activation, **WIDTHS),
                             r_config=RefineConfig(activation=activation, **WIDTHS), device="cpu",
                             diffusion_steps=8)
    _assert_forward_matches("g", pipe.g_model, JC.load_checkpoint(g)["1"], activation)
    _assert_forward_matches("r", pipe.refine_net, JC.load_checkpoint(r)["1"], activation)


@pytest.mark.parametrize("launcher,kind", [(train_g, "g"), (train_r, "r"), (train_encoder, "encoder")],
                         ids=["train_g", "train_r", "train_encoder"])
def test_train_launchers_resume_from_a_jax_ckpt(launcher, kind, jax_files, tmp_path, monkeypatch):
    """--train.reload_ckpt_model_filepath with a JAX .ckpt: the run starts
    from the file's weights at its step (2) and at the learning rate the
    optax schedule has there under the config's milestones (smoke: epoch 1,
    here step 1 of batch 8 for G and R), and goes on counting from there."""
    monkeypatch.chdir(tmp_path)
    path = jax_files[kind]["path"]
    at_load = {}

    def load(p, state, strict=False, _real=launcher.load_checkpoint):
        _real(p, state, strict)
        at_load.update(step=state.step, lr=state.optimizer.lr, sd={k: v.clone() for k, v in
                                                                  state.model.state_dict().items()})
        return state

    monkeypatch.setattr(launcher, "load_checkpoint", load)
    state = launcher.main([*CPU, "--data.synthetic_size", "8", "--train.num_epoch", "1",
                           "--train.reload_ckpt_model_filepath", path])
    for k, v in FROM_FLAX[kind](JC.load_checkpoint(path)["1"]).items():
        assert torch.equal(at_load["sd"][k], v.to(at_load["sd"][k].dtype)), k
    sched = state.optimizer.scheduler
    assert at_load["step"] == 2
    assert at_load["lr"] == 1e-4 * 0.5 ** sum(c for m, c in sched.milestones.items() if m <= 2)
    assert state.step > 2 and sched.last_epoch == state.step
    assert {float(s["step"]) for s in state.optimizer.adamw.state.values()} == {float(state.step)}


@pytest.mark.parametrize("kind", KINDS)
def test_a_bare_variables_pickle_loads(kind, jax_files, tmp_path):
    """The JAX package's save_checkpoint(path, params): weights, no step and
    no optimizer."""
    variables = jax_files[kind]["state"].params
    path = str(tmp_path / "params.ckpt")
    JC.save_checkpoint(path, variables)
    model = PORT_MODELS[kind]()
    load_model_weights(model, path)
    sd = model.state_dict()
    for k, v in FROM_FLAX[kind](variables).items():
        assert torch.equal(sd[k], v), k
    state = _port_state(kind)
    load_checkpoint(path, state)
    assert state.step == 0 and not state.optimizer.adamw.state and state.optimizer.lr == BASE_LR
    with pytest.raises(KeyError, match="no optimizer state"):
        load_checkpoint(path, state, strict=True)


class _Reg:
    def select(self, name):
        return {"activation": "gelu"}


def test_an_orbax_directory_is_refused(tmp_path):
    d = tmp_path / "model_0001.orbax"
    d.mkdir()
    state = _port_state("g")
    for path in (str(d), str(tmp_path)):
        with pytest.raises(ValueError, match='backend="pickle"'):
            load_model_weights(state.model, path)
        with pytest.raises(ValueError, match="orbax checkpoint directory"):
            load_checkpoint(path, state)
    assert common.activation_for_checkpoint(_Reg(), str(d)) is None


class _Payload:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


def test_a_pickle_with_a_foreign_global_is_refused(tmp_path):
    marker = tmp_path / "ran"
    path = tmp_path / "model_0001.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"0": np.zeros((), np.int32), "1/params/w": _Payload(str(marker))}, f)
    with pytest.raises(ValueError, match=r"refusing global (os|posix)\.system"):
        load_model_weights(PORT_MODELS["g"](), str(path))
    assert not marker.exists()


def test_numpy_1_module_names_are_read(tmp_path):
    """A file written under numpy 1.x names numpy.core.*; protocol 3 (text
    GLOBAL opcodes, ndarray through _reconstruct) lets the test write one."""
    flat = {"params/w": np.arange(6, dtype=np.float32).reshape(2, 3).T, "params/b": np.asarray(2.5, np.float32)}
    data = pickle.dumps(flat, protocol=3).replace(b"numpy._core.", b"numpy.core.")
    assert b"numpy.core.multiarray\n_reconstruct" in data and b"numpy._core" not in data
    path = tmp_path / "params.ckpt"
    path.write_bytes(data)
    ck = from_jax.read_jax_checkpoint(str(path))
    assert ck.step is None and ck.mu is None
    np.testing.assert_array_equal(ck.variables["params"]["w"], flat["params/w"])
    assert ck.variables["params"]["b"].shape == () and ck.variables["params"]["b"] == 2.5
