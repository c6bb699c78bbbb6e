"""The port on several processes (parallel/mesh.py, the train steps and the
launchers under a torch.distributed group) against the JAX package's
global-batch semantics, on the CPU.

Two worker processes join one gloo group through a file:// rendezvous in
the test's own tmp dir (no TCP port, so parallel test workers cannot
collide), each single-threaded. JAX runs in this process on conftest's
virtual CPU devices, its steps on `make_mesh(2)` with the global batch
sharded over the two devices. Each rank of the port takes its half of the
same rows, the same weights (interop/from_jax), fixed timesteps and its
rows of JAX's global q_sample noise.

Tolerances, float32 on both sides, dropout 0 and cond_mask_prob 0 (the two
frameworks draw different masks, and W ranks draw theirs per rank):
- the G step (composed route, extra loss on): loss and terms rtol 1e-4;
  clipped gradients rtol 2e-3 / atol 1e-6, as the one-process test
  (tests/test_torch_train_g.py) holds them. With t_weights 0 the gradients
  are the extra terms alone, where a missing factor W would be off 2x;
- the R step: loss rtol 1e-5, each clipped gradient within 1e-4 of its
  norm plus 1e-7 (tests/test_torch_r_train.py's bounds);
- the encoder step: loss rtol 1e-4, accuracy rtol 1e-6, gradients rtol
  2e-3 / atol 1e-6;
- the ranks' parameters after their steps: bitwise equal;
- the in-step draws: t equal, per-sample losses rtol 1e-5 against one
  process on the whole batch with the same generator seed.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from oakink2_tamf_tpu.core import diffusion as JD
from oakink2_tamf_tpu.core import mano as JM
from oakink2_tamf_tpu.data.synthetic import synthetic_batch, with_perturbed_sample
from oakink2_tamf_tpu.models import encoder as JENC
from oakink2_tamf_tpu.models import losses as JLL
from oakink2_tamf_tpu.models import mdm_g as JMDM
from oakink2_tamf_tpu.models import refine_r as JR
from oakink2_tamf_tpu.parallel import train as JPT
from oakink2_tamf_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data.adaptors import NUM_ACTIONS
from oakink2_tamf_tpu_torch.interop import from_jax
from oakink2_tamf_tpu_torch.launch import common, param
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import mdm_g as MDM
from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models
from oakink2_tamf_tpu_torch.parallel import mesh
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime.config import ConfigRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "config", "synthetic_smoke.yml")
G_SMALL = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
ENC_SMALL = dict(latent_dim=32, ff_size=64, num_layers=2, num_heads=4, dropout=0.0)
BS, W = 4, 2  # the global batch, the ranks
G_T = np.array([3, 41, 17, 29], np.int32)
G_WEIGHTS = {"weighted": np.array([1.0, 0.5, 0.75, 1.0], np.float32), "extra_only": np.zeros(BS, np.float32)}
R_KEYS = ("pose_repr", "sample_pose_repr", "mask", "shape", "hand_side", "obj_traj",
          "obj_embedding", "obj_mask", "obj_points")
ENC_KEYS = ("pose_repr", "sample_pose_repr", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask",
            "action_label_id")

# Every worker: single-threaded, into the gloo group of 2 through a file in
# the shared dir; argv = [rank, shared dir]. TensorFlow's import is blocked:
# torch.utils.tensorboard (rank 0's summary writer) would spend ~16 s on it
# and writes the same events through tensorboard's own stub without it.
PROLOGUE = """
import os, sys, json
sys.modules["tensorflow"] = None
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
from oakink2_tamf_tpu_torch.parallel import mesh
RANK, SHARED = int(sys.argv[1]), sys.argv[2]
mesh.init_distributed(backend="gloo", init_method="file://" + os.path.join(SHARED, "rendezvous"),
                      world_size=2, rank=RANK)
assert mesh.world_size() == 2 and mesh.rank() == RANK
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch single-threaded for this file under pytest-xdist: the workers
    share the cores, and each one's intra-op threads would spin against the
    others' (six concurrent train_r.main smoke runs took ~144 s each at 8
    threads, ~38 s at 1, on an 8-core host). A serial run keeps them all."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(body: str, shared, timeout: float = 300.0) -> list[str]:
    """Run PROLOGUE + body in two processes, each from its own cwd
    shared/rank{r}; every rank must exit 0. -> their outputs."""
    script = shared / "worker.py"
    script.write_text(PROLOGUE.format(repo=REPO) + textwrap.dedent(body))
    procs = []
    for r in range(W):
        cwd = shared / f"rank{r}"
        cwd.mkdir(exist_ok=True)
        procs.append(subprocess.Popen([sys.executable, str(script), str(r), str(shared)], cwd=cwd,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, deadline = [], time.time() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}\n{out[-6000:]}"
    return outs


def _capture():
    """An optax transformation that returns zero updates and keeps the
    gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), u))


def _jax_mesh_step(make_step, params, batch, key):
    """One JAX step over make_mesh(2) with the capturing optimizer ->
    (metrics as floats, clipped gradients)."""
    m = make_mesh(W)
    capture = _capture()
    state = replicate(JPT.init_train_state(jax.tree.map(jnp.asarray, params), capture), m)
    state, metrics = make_step(capture, m)(state, shard_batch(batch, m), key)
    clipped, _ = JPT.per_param_clip(0.1).update(state.opt_state, None)
    scalars = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
    return scalars, jax.tree.map(np.asarray, clipped)


def _port_tree(convert, tree) -> dict:
    return {k: v.numpy() for k, v in convert(jax.tree.map(np.asarray, tree)).items()}


def _r_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    b = synthetic_batch(rng, batch_size=BS, seq_len=8, max_nobj=2, n_obj_points=64, min_len=5, as_jax=False)
    b = with_perturbed_sample(b, rng)
    b["sample_pose_repr"] = np.asarray(b["sample_pose_repr"])
    return {k: b[k] for k in R_KEYS}


def _enc_batch(seed: int) -> dict:
    b = synthetic_batch(np.random.default_rng(seed), batch_size=BS, seq_len=20, max_nobj=3, n_obj_points=16,
                        as_jax=False)
    b["sample_pose_repr"] = (b["pose_repr"] + np.random.default_rng(seed + 1).normal(
        scale=0.05, size=b["pose_repr"].shape)).astype(np.float32)
    b["action_label_id"] = b["action_label_id"] % NUM_ACTIONS
    return {k: b[k] for k in ENC_KEYS}


# G's eval pass (launch/train_g.evaluate_g): DDPM and the Picard-parallel
# sampler on a 10-step schedule (window 4, so the parallel sampler slides)
EVAL = {"samplers": ("ddpm", "parallel"), "T": 10, "window": 4, "seed": 11}

STEPS_BODY = """
from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data.loader import DataLoader
from oakink2_tamf_tpu_torch.launch import common
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import mdm_g as MDM
from oakink2_tamf_tpu_torch.models import refine_r as R
from oakink2_tamf_tpu_torch.models.encoder import EncoderConfig, SegmentEncoder
from oakink2_tamf_tpu_torch.parallel import train as PT

inp = torch.load(os.path.join(SHARED, "inputs.pt"), weights_only=False)  # written by the test
rows = slice(RANK * 2, RANK * 2 + 2)


def mine(batch):
    return {k: torch.from_numpy(np.asarray(v)[rows]) for k, v in batch.items()}


def record(state, metrics):
    return {"metrics": {k: v.numpy() for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in state.model.named_parameters() if p.grad is not None},
            "params": {k: p.detach().clone() for k, p in state.model.named_parameters()}}


res = {}
mano = R.stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
assets = LL.load_contact_assets()
g_step = PT.make_g_train_step(D.tamf_schedule(50), mano, assets, LL.ExtraLossConfig(), dist_impl="composed")
for case, weights in inp["g_weights"].items():
    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**inp["g_cfg"]))
    model.load_state_dict(inp["g_sd"])
    state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
    batch = mine(dict(inp["g_batch"], t_weights=weights))
    res["g_" + case] = record(state, g_step(state, batch, noise=torch.from_numpy(inp["g_noise"][rows])))
    if case == "weighted":  # a second step: the ranks must still agree bit for bit
        g_step(state, batch, noise=torch.from_numpy(inp["g_noise"][rows]))
        res["g_two_steps"] = {k: p.detach().clone() for k, p in model.named_parameters()}

# the in-step draws: no t, no noise; one generator seeded alike on both ranks
model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**inp["g_cfg"]))
model.load_state_dict(inp["g_sd"])
state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
batch = {k: v for k, v in mine(inp["g_batch"]).items() if k != "t"}
m = g_step(state, batch, generator=torch.Generator().manual_seed(7))
res["g_draws"] = {k: m[k].clone() for k in ("per_sample_t", "per_sample_mse", "loss", "t_mean")}

net = R.SegmentRefineNet(R.RefineConfig(**inp["g_cfg"]))
net.load_state_dict(inp["r_sd"])
state = PT.TrainState(net, PT.make_optimizer(net.named_parameters()))
r_step = PT.make_r_train_step(mano, assets, LL.RefineLossConfig())
res["r"] = record(state, r_step(state, mine(inp["r_batch"])))

enc = SegmentEncoder(EncoderConfig(**inp["enc_cfg"]))
enc.load_state_dict(inp["enc_sd"])
state = PT.TrainState(enc, PT.make_optimizer(enc.named_parameters()))
res["enc"] = record(state, PT.make_encoder_train_step()(state, mine(inp["enc_batch"])))

# G's eval pass on this rank's rows of the G batch, one sampler at a time
from oakink2_tamf_tpu_torch.launch import train_g
eval_batch = {k: v for k, v in mine(inp["g_batch"]).items() if k != "t"}
for sampler in inp["eval"]["samplers"]:
    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**inp["g_cfg"]))
    model.load_state_dict(inp["g_sd"])
    sample_fn = PT.make_g_sampler(D.tamf_schedule(inp["eval"]["T"]), sampler=sampler,
                                  parallel_window=inp["eval"]["window"])
    res["eval_" + sampler] = train_g.evaluate_g(sample_fn, model, mano, assets, LL.ExtraLossConfig(), [eval_batch],
                                                None, torch.device("cpu"),
                                                torch.Generator().manual_seed(inp["eval"]["seed"]))

# the parallel sampler's slide on the global batch: a stand-in x0 model
# whose rows converge at different speeds, rank 1's faster
k = torch.tensor([3.0, 3.0, 0.5, 0.5])[rows]  # slide_model's k on this rank's rows
slide_model = lambda x, t: torch.tanh(k.repeat(x.shape[0] // 2)[:, None, None] * x
                                      + 0.1 * torch.sin(t.to(torch.float32))[:, None, None])
res["slide"] = D.p_sample_loop_parallel(
    slide_model, D.tamf_schedule(50), (2, 8, 6), device="cpu", generator=torch.Generator().manual_seed(0),
    draw=mesh.global_randn, batch_max=mesh.all_reduce_max, window=8, tol=0.1, return_info=True)

# the loader's stripe of 9 samples, and the samplers' shard
loader = DataLoader([{"i": i} for i in range(9)], batch_size=2, shuffle=True, drop_last=False, seed=3,
                    collate_fn=lambda items: np.array([d["i"] for d in items]), num_workers=1)
loader.set_epoch(1)
res["stripe"] = [int(i) for b in loader for i in b]
res["shard"] = common.resolve_shard({})
res["gathered"] = mesh.all_gather_rows(torch.arange(3) + 10 * RANK)
res["rows"] = mesh.shard_rows(torch.arange(8))
res["global_randn"] = mesh.global_randn((2, 3), torch.Generator().manual_seed(1), "cpu")
res["max"] = mesh.all_reduce_max(torch.tensor([float(RANK), 1.0 - RANK, 5.0]))
res["metrics"] = mesh.reduce_metrics({"m": torch.tensor(float(RANK)), "s": torch.tensor(RANK + 1.0),
                                      "v": torch.ones(2)}, {"s": "sum"})
res["batch_means"] = mesh.reduce_batch_means({"m": [float(RANK), RANK + 2.0], "s": [1.0, 3.0]}, sums=["s"])
# a gradient on one rank only, and none on either
a, b, c = (torch.nn.Parameter(torch.zeros(n)) for n in (3, 2, 1))
a.grad = torch.full((3,), RANK + 1.0)
if RANK == 1:
    b.grad = torch.full((2,), 4.0)
mesh.all_reduce_grads_([a, b, c])
res["missing_grad"] = (a.grad, b.grad, c.grad)
torch.save(res, os.path.join(SHARED, f"res{RANK}.pt"))
"""


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The JAX package's mesh steps here, the port's on two ranks. ->
    (JAX results, [rank 0's, rank 1's], the inputs the ranks were given)."""
    shared = tmp_path_factory.mktemp("steps")
    jst = JR.stack_mano_models(JM.synthetic_mano_model("right"), JM.synthetic_mano_model("left"))
    assets = JLL.load_contact_assets()
    want, inp = {}, {"g_cfg": G_SMALL, "enc_cfg": ENC_SMALL, "g_weights": G_WEIGHTS, "eval": EVAL}

    # G: the extra loss on, fixed t, JAX's own global noise
    gb = synthetic_batch(np.random.default_rng(3), batch_size=BS, seq_len=8, max_nobj=2, n_obj_points=64,
                         min_len=5, as_jax=False)
    gb["t"] = G_T
    jmodel = JMDM.InteractionSegmentMDM(JMDM.MDMConfig(**G_SMALL))
    gparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), gb["pose_repr"], np.zeros((BS,), np.int32),
                                                   JPT.g_cond_from_batch(gb)))
    key = jax.random.PRNGKey(5)
    jstep = {}

    def make_g(opt, m):
        if "g" not in jstep:
            jstep["g"] = JPT.make_g_train_step(jmodel, JD.tamf_schedule(50), opt, jst, assets, JLL.ExtraLossConfig(),
                                               chunk=64, mesh=m, dist_impl="composed")
        return jstep["g"]

    for case, weights in G_WEIGHTS.items():
        metrics, clipped = _jax_mesh_step(make_g, gparams, dict(gb, t_weights=weights), key)
        want["g_" + case] = (metrics, _port_tree(from_jax.g_state_dict_from_flax, clipped))
    inp.update(g_sd=from_jax.g_state_dict_from_flax(gparams), g_batch=gb,
               g_noise=np.asarray(jax.random.normal(jax.random.split(key, 4)[1], gb["pose_repr"].shape, jnp.float32)))

    # R: the all-pairs route at 64 points
    rb = _r_batch(4)
    jnet = JR.SegmentRefineNet(JR.RefineConfig(**G_SMALL))
    rparams = jax.tree.map(np.asarray, jnet.init(
        jax.random.PRNGKey(0), rb["sample_pose_repr"], np.zeros(rb["mask"].shape + (778,), np.float32),
        {k: rb[k] for k in ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")}))
    metrics, clipped = _jax_mesh_step(
        lambda opt, m: JPT.make_r_train_step(jnet, opt, jst, assets, JLL.RefineLossConfig(), chunk=64, mesh=m),
        rparams, rb, jax.random.PRNGKey(1))
    want["r"] = (metrics, _port_tree(from_jax.r_state_dict_from_flax, clipped))
    inp.update(r_sd=from_jax.r_state_dict_from_flax(rparams), r_batch=rb)

    # the FID encoder on sample_pose_repr
    eb = _enc_batch(10)
    jenc = JENC.SegmentEncoder(JENC.EncoderConfig(**ENC_SMALL))
    evars = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0), eb["pose_repr"],
                                               {k: eb[k] for k in ENC_KEYS[2:7]}))
    metrics, clipped = _jax_mesh_step(lambda opt, m: JPT.make_encoder_train_step(jenc, opt, mesh=m), evars, eb,
                                      jax.random.PRNGKey(2))
    want["enc"] = (metrics, _port_tree(from_jax.encoder_state_dict_from_flax, clipped))
    inp.update(enc_sd=from_jax.encoder_state_dict_from_flax(evars), enc_batch=eb)

    torch.save(inp, shared / "inputs.pt")
    run_ranks(STEPS_BODY, shared)
    return want, [torch.load(shared / f"res{r}.pt", weights_only=False) for r in range(W)], inp


def _assert_grads(got: dict, want: dict, rtol: float, atol: float, label: str) -> None:
    assert set(got) <= set(want) and got, label
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k], rtol=rtol, atol=atol, err_msg=f"{label}: {k}")


@pytest.mark.parametrize("case", list(G_WEIGHTS))
def test_two_rank_g_step_matches_jax_mesh(steps, case):
    """Two ranks of the port's G step against JAX's make_g_train_step on a
    2-device mesh: the extra terms are batch sums, so each rank scales its
    own by W before backward() and the gradients' mean is the global sum."""
    want, res, _ = steps
    wm, wg = want["g_" + case]
    for r in range(W):
        got = res[r]["g_" + case]
        for k in ("loss", "diffusion_loss", "extra/loss", "extra/dist_o", "extra/dist_h", "extra/rec_vert"):
            np.testing.assert_allclose(float(got["metrics"][k]), wm[k], rtol=1e-4, atol=1e-12,
                                       err_msg=f"rank {r}: {k}")
        np.testing.assert_array_equal(got["metrics"]["per_sample_t"], G_T)  # gathered in rank order
        _assert_grads(got["grads"], wg, 2e-3, 1e-6, f"rank {r}, {case}")
    if case == "extra_only":
        assert wm["diffusion_loss"] == 0.0
        assert max(float(g.abs().max()) for g in res[0]["g_extra_only"]["grads"].values()) > 1e-4


def test_two_rank_r_step_matches_jax_mesh(steps):
    want, res, _ = steps
    wm, wg = want["r"]
    for r in range(W):
        got = res[r]["r"]
        for k in ("loss", "rec_joint", "rec_vert", "dist_h"):
            np.testing.assert_allclose(float(got["metrics"][k]), wm[k], rtol=1e-5, err_msg=f"rank {r}: {k}")
        assert set(got["grads"]) == set(wg)
        for k, g in got["grads"].items():
            assert np.linalg.norm(g.numpy() - wg[k]) <= 1e-4 * np.linalg.norm(wg[k]) + 1e-7, f"rank {r}: {k}"


def test_two_rank_encoder_step_matches_jax_mesh(steps):
    want, res, _ = steps
    wm, wg = want["enc"]
    for r in range(W):
        got = res[r]["enc"]
        np.testing.assert_allclose(float(got["metrics"]["loss"]), wm["loss"], rtol=1e-4)
        np.testing.assert_allclose(float(got["metrics"]["acc"]), wm["acc"], rtol=1e-6)
        _assert_grads(got["grads"], wg, 2e-3, 1e-6, f"rank {r}")


def test_ranks_end_bitwise_equal(steps):
    _, res, _ = steps
    for key in ("g_weighted", "g_extra_only", "r", "enc"):
        for k, a in res[0][key]["params"].items():
            assert torch.equal(a, res[1][key]["params"][k]), f"{key}: {k}"
    for k, a in res[0]["g_two_steps"].items():
        assert torch.equal(a, res[1]["g_two_steps"][k]), k


def test_in_step_draws_are_rows_of_one_global_draw(steps):
    """Without t or noise in the batch, each rank's timesteps and q_sample
    noise are its rows of one draw over the global batch: the gathered
    per-sample values equal one process's on the whole batch."""
    _, res, inp = steps
    gb = {k: torch.from_numpy(np.asarray(v)) for k, v in inp["g_batch"].items() if k != "t"}
    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**G_SMALL))
    model.load_state_dict(inp["g_sd"])
    state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    step = PT.make_g_train_step(D.tamf_schedule(50), mano, LL.load_contact_assets(), LL.ExtraLossConfig(),
                                dist_impl="composed")
    one = step(state, gb, generator=torch.Generator().manual_seed(7))
    for r in range(W):
        got = res[r]["g_draws"]
        assert torch.equal(got["per_sample_t"], one["per_sample_t"]), r
        torch.testing.assert_close(got["per_sample_mse"], one["per_sample_mse"], rtol=1e-5, atol=0)
        torch.testing.assert_close(got["loss"], one["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(got["t_mean"], one["t_mean"], rtol=0, atol=0)


@pytest.mark.parametrize("sampler", EVAL["samplers"])
def test_two_rank_eval_pass_matches_one_process(steps, sampler):
    """G's eval pass on two ranks, rank r on global rows [2r, 2r + 2) of
    the G batch, against one process on the 4 rows in global order with
    the generator in the same state: each global row gets its own x_T and
    step noise (this rank's rows of one global draw per step), and the
    parallel sampler slides on the global batch's drift, so sample_mse and
    the extra terms agree (rtol 1e-5, the float32 sums of two batches of
    2 against one of 4)."""
    from oakink2_tamf_tpu_torch.launch import train_g

    _, res, inp = steps
    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**G_SMALL))
    model.load_state_dict(inp["g_sd"])
    mano = stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in inp["g_batch"].items() if k != "t"}
    sample_fn = PT.make_g_sampler(D.tamf_schedule(EVAL["T"]), sampler=sampler, parallel_window=EVAL["window"])
    want = train_g.evaluate_g(sample_fn, model, mano, LL.load_contact_assets(), LL.ExtraLossConfig(), [batch], None,
                              torch.device("cpu"), torch.Generator().manual_seed(EVAL["seed"]))
    assert {"sample_mse", "dist_o", "dist_h"} <= set(want)
    for r in range(W):
        got = res[r]["eval_" + sampler]
        assert set(got) == set(want), r
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-12, err_msg=f"rank {r}: {k}")


def slide_model(rows=slice(0, 4)):
    """The stand-in x0 model of the slide check, on `rows` of the 4:
    tanh(k x + 0.1 sin t), k = 3 on rows 0-1 and 0.5 on rows 2-3."""
    k = torch.tensor([3.0, 3.0, 0.5, 0.5])[rows]
    return lambda x, t: torch.tanh(k.repeat(x.shape[0] // len(k))[:, None, None] * x
                                   + 0.1 * torch.sin(t.to(torch.float32))[:, None, None])


def test_two_rank_parallel_sampler_slides_on_the_global_batch(steps):
    """The Picard-parallel sampler under a group: each rank's rows of one
    global draw per timestep, and the window's drift maxed over the ranks
    (mesh.all_reduce_max), so both ranks take one process's sweeps on the
    4 rows and their rows of its sample. Rank 1's rows alone would slide
    faster (its smaller k converges sooner), so without the max the
    ranks would part."""
    _, res, _ = steps
    sched = D.tamf_schedule(50)
    one, info = D.p_sample_loop_parallel(slide_model(), sched, (4, 8, 6), device="cpu",
                                         generator=torch.Generator().manual_seed(0), window=8, tol=0.1,
                                         return_info=True)
    g = torch.Generator().manual_seed(0)
    x_t = torch.randn((4, 8, 6), generator=g)
    t_noise = torch.stack([torch.randn((4, 8, 6), generator=g) for _ in range(50)]).flip(0)  # drawn T-1 .. 0
    _, alone = D.p_sample_loop_parallel(slide_model(slice(2, 4)), sched, (2, 8, 6), device="cpu", noise=x_t[2:],
                                        t_noise=t_noise[:, 2:], window=8, tol=0.1, return_info=True)
    assert alone["n_sweeps"] < info["n_sweeps"]
    for r in range(W):
        sample, got = res[r]["slide"]
        assert got == info, r
        torch.testing.assert_close(sample, one[2 * r : 2 * r + 2], rtol=0, atol=1e-6)


def test_global_randn_is_rows_of_one_draw(steps):
    """mesh.global_randn: rank r's rows [2r, 2r + 2) of the draw one
    process makes over 4 rows; all_reduce_max: the ranks' elementwise max."""
    _, res, _ = steps
    full = torch.randn((4, 3), generator=torch.Generator().manual_seed(1))
    for r in range(W):
        assert torch.equal(res[r]["global_randn"], full[2 * r : 2 * r + 2]), r
        assert res[r]["max"].tolist() == [1.0, 1.0, 5.0]
    one = mesh.global_randn((4, 3), torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(one, full)  # one process: the draw itself, bit for bit


def test_loader_stripes_nine_over_two(steps):
    """9 samples over 2 ranks: the permutation wrap-padded to 10, 5 each,
    together all 9 (JAX's DistributedSampler semantics)."""
    _, res, _ = steps
    s0, s1 = res[0]["stripe"], res[1]["stripe"]
    assert len(s0) == len(s1) == 5
    assert set(s0) | set(s1) == set(range(9))


def test_helpers_and_resolve_shard_under_a_live_group(steps):
    _, res, _ = steps
    for r in range(W):
        assert tuple(res[r]["shard"]) == (r, W)
        assert res[r]["gathered"].tolist() == [0, 1, 2, 10, 11, 12]
        assert res[r]["rows"].tolist() == list(range(4 * r, 4 * r + 4))
        m = res[r]["metrics"]
        assert float(m["m"]) == 0.5 and float(m["s"]) == 3.0 and m["v"].tolist() == [1.0, 1.0]
        # global batch i is the ranks' batch i: means over 4 batch values, sums over the ranks first
        assert res[r]["batch_means"] == {"m": 1.5, "s": 4.0}


def test_a_gradient_missing_on_a_rank_counts_as_zeros(steps):
    """A parameter without a gradient on one rank gets the ranks' mean (its
    zeros there) on both; one without a gradient anywhere keeps none."""
    _, res, _ = steps
    for r in range(W):
        a, b, c = res[r]["missing_grad"]
        assert a.tolist() == [1.5] * 3 and b.tolist() == [2.0, 2.0] and c is None


LAUNCH_BODY = """
from oakink2_tamf_tpu_torch.launch import sample_r, train_r

smoke = {smoke!r}
state = train_r.main(["--cfg", smoke, "--runtime.device", "cpu", "--runtime.num_worker", "1",
                      "--exp_id", "dist_r", "--train.num_epoch", "1", "--train.val_freq", "1",
                      "--train.eval_max_batches", "1", "--commit",
                      "--train.data.target_h2o_cache_dir", os.path.join(SHARED, "h2o_cache")])
torch.save({{"step": state.step, "params": {{k: p.detach() for k, p in state.model.named_parameters()}}}},
           os.path.join(SHARED, f"train_r{{RANK}}.pt"))
out_root = sample_r.main(["--cfg", smoke, "--runtime.device", "cpu", "--exp_id", "dist_sr",
                          "--sample.batch_size", "4", "--sample.split", "test", "--commit"])
keys = sorted(os.path.relpath(os.path.join(root, f), out_root)
              for root, _, files in os.walk(out_root) for f in files if f == "save_dict.pkl")
with open(os.path.join(SHARED, f"tree{{RANK}}.json"), "w") as f:
    json.dump(keys, f)
"""


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """train_r.main (one epoch, a val pass, a shared target-h2o cache dir,
    --commit) and then sample_r.main (--commit) on two ranks, each from its
    own cwd. -> (shared dir, [rank 0's output, rank 1's])."""
    shared = tmp_path_factory.mktemp("launch")
    outs = run_ranks(LAUNCH_BODY.format(smoke=SMOKE), shared)
    return shared, outs


def test_train_r_main_on_two_processes(launched):
    """Both ranks end with the same parameters after the epoch's global
    steps; their striped precompute fills the shared cache; only rank 0
    writes checkpoints, opt.yml and the eval line."""
    shared, outs = launched
    res = [torch.load(shared / f"train_r{r}.pt", weights_only=False) for r in range(W)]
    assert res[0]["step"] == res[1]["step"] == 1  # 16 segments over 2 ranks of batch 8
    for k, a in res[0]["params"].items():
        assert torch.equal(a, res[1]["params"][k]), k
    cache = shared / "h2o_cache"
    assert len([p for p in cache.iterdir() if p.suffix == ".npy"]) == 16
    assert (cache / "meta.json").exists()
    run = [shared / f"rank{r}" / "common" / "train_r" / "dist_r" for r in range(W)]
    assert sorted(os.listdir(run[0] / "save")) == ["model_0000.pt"]
    assert (run[0] / "opt.yml").exists() and (run[0] / "summary" / "scalars.jsonl").exists()
    assert not (run[1] / "save").exists() and not (run[1] / "opt.yml").exists()
    assert "val epoch 0000 refine eval" in outs[0] and "refine eval" not in outs[1]
    assert "process group: rank 1 of 2 (gloo)" in outs[1]


def test_sample_r_main_on_two_processes(launched):
    """Each rank refines its own contiguous shard: the trees are disjoint
    and together hold every one of the 16 segments."""
    shared, _ = launched
    trees = [set(json.loads((shared / f"tree{r}.json").read_text())) for r in range(W)]
    assert trees[0] and trees[1] and not trees[0] & trees[1]
    assert len(trees[0] | trees[1]) == 16


def _registry(argv=()) -> ConfigRegistry:
    import argparse

    reg = ConfigRegistry("train_r")
    param.reg_base_param(reg)
    parser = argparse.ArgumentParser()
    reg.hook(parser)
    reg.parse(parser, ["--cfg", SMOKE, "--runtime.device", "cpu", *argv])
    return reg


def _torchrun_env(monkeypatch, **env):
    for k in common.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


def test_maybe_init_distributed_without_the_environment_makes_no_group(monkeypatch):
    _torchrun_env(monkeypatch)
    common.maybe_init_distributed(_registry())
    assert not mesh.is_live() and mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_coordinator()


@pytest.mark.parametrize("env,argv,match", [
    (dict(RANK=0, WORLD_SIZE=2), (), "incomplete torchrun environment"),
    (dict(RANK=2, WORLD_SIZE=2, LOCAL_RANK=0, MASTER_ADDR="localhost", MASTER_PORT=1), (), "out of range"),
    # the CPU build has no NCCL: init_process_group itself fails, and nothing swallows it
    (dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="localhost", MASTER_PORT=0),
     ("--runtime.dist_backend", "nccl"), "NCCL|nccl"),
])
def test_maybe_init_distributed_raises_on_a_bad_environment(monkeypatch, env, argv, match):
    """A broken environment or a failed init raises: no fallback to one
    process (the JAX package logs a warning and goes on)."""
    _torchrun_env(monkeypatch, **env)
    with pytest.raises((RuntimeError, ValueError), match=match):
        common.maybe_init_distributed(_registry(argv))
    assert not mesh.is_live()


def test_device_count_must_match_the_world_size(monkeypatch):
    _torchrun_env(monkeypatch)
    assert common.run_device(_registry(("--runtime.device_count", "1"))) == torch.device("cpu")
    with pytest.raises(ValueError, match="device_count 2 but 1 process"):
        common.run_device(_registry(("--runtime.device_count", "2")))


def test_local_rank_without_a_card_raises(monkeypatch):
    """"cuda" is the card of LOCAL_RANK; a LOCAL_RANK beyond the visible
    cards raises unless runtime.device names one (two ranks sharing card 0
    under gloo)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no CUDA device"):
        mesh.local_device("cuda")
    assert mesh.local_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert mesh.local_device("cuda") == torch.device("cuda", 0)
    monkeypatch.delenv("LOCAL_RANK")
    assert mesh.local_device("cuda") == torch.device("cuda")


def test_helpers_are_the_identity_without_a_group():
    x = torch.arange(6.0)
    assert mesh.shard_rows(x) is x and mesh.all_gather_rows(x) is x
    m = {"a": torch.tensor(2.0), "v": torch.ones(3)}
    assert mesh.reduce_metrics(m, {"a": "sum"}) == m
    assert mesh.reduce_batch_means({"a": [1.0, 3.0], "b": [4.0]}, sums=["b"]) == {"a": 2.0, "b": 4.0}
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    mesh.all_reduce_grads_([p])
    assert p.grad.tolist() == [3.0, 3.0]
