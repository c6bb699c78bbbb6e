"""The port's samplers (oakink2_tamf_tpu_torch/core/diffusion.py) against the
JAX package's, on the stand-in x0 model of tests/test_parallel_sampler.py
(T = 50, x [2, 8, 6]) with the JAX chain's own noise fed to the port.

Each JAX sampler derives its noise from one key, and the port takes it
under the name that says how it is indexed:
- DDPM and DDIM: `key, k_init = split(key)`; x_T = normal(k_init); the
  per-step noise is normal(split(key, S)[i]), i in chain order
  (`step_noise`);
- PLMS: x_T only;
- parallel: z_t = normal(fold_in(key, t)), indexed by the timestep t
  (`t_noise`).

Tolerances: atol 1e-5 for the sequential chains, 1e-4 for the parallel
sampler at tol 1e-2 (its cumsum's float32 order differs between XLA and
PyTorch), and its sweep count must be equal. JAX is imported inside the
JAX tests: the card's machine, which runs this file's cuda tests, has none.
"""

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.core import diffusion as D

SHAPE = (2, 8, 6)
T = 50
ATOL = 1e-5


def model_fn(x, t_model):
    """The stand-in x0 predictor (bounded, t-dependent)."""
    return torch.tanh(0.9 * x + 0.1 * torch.sin(t_model.to(torch.float32))[:, None, None])


def cond_fn(x, t_model):
    """An analytic guidance gradient: of -0.05 |x - 0.2|^2 (1 + t/100)."""
    return -0.1 * (x - 0.2) * (1 + t_model.to(torch.float32) / 100)[:, None, None]


def denoised_fn(x0):
    return 1.5 * x0 - 0.1  # pushes the prediction outside [-1, 1], so the clip acts


def _jax_fns():
    import jax.numpy as jnp

    return (
        lambda x, t: jnp.tanh(0.9 * x + 0.1 * jnp.sin(t.astype(jnp.float32))[:, None, None]),
        lambda x, t: -0.1 * (x - 0.2) * (1 + t.astype(jnp.float32) / 100)[:, None, None],
        lambda x0: 1.5 * x0 - 0.1,
    )


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _chain_noise(key, n_steps, shape=SHAPE):
    """(x_T, step_noise [n_steps, ...]) as DDPM and DDIM draw them from `key`."""
    import jax
    import jax.numpy as jnp

    key, k_init = jax.random.split(key)
    x_t = jax.random.normal(k_init, shape, jnp.float32)
    steps = [jax.random.normal(k, shape, jnp.float32) for k in jax.random.split(key, n_steps)]
    return _t(x_t), _t(np.stack(steps))


def _t_noise(key, n_t, shape=SHAPE):
    """(x_T, t_noise [T, ...]): the parallel sampler's pinned noise by timestep."""
    import jax
    import jax.numpy as jnp

    key, k_init = jax.random.split(key)
    x_t = jax.random.normal(k_init, shape, jnp.float32)
    zs = [jax.random.normal(jax.random.fold_in(key, t), shape, jnp.float32) for t in range(n_t)]
    return _t(x_t), _t(np.stack(zs))


def _scheds(respacing=""):
    from oakink2_tamf_tpu.core import diffusion as JD

    return D.tamf_schedule(T, "cosine", respacing), JD.tamf_schedule(T, "cosine", respacing)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


# ---------------------------------------------------------------------------
# DDPM and its trajectory
# ---------------------------------------------------------------------------

DDPM_CASES = {
    "plain": {},
    "const_noise": dict(const_noise=True),
    "skip_no_init": dict(skip_timesteps=20),
    "skip_and_init": dict(skip_timesteps=20, init_image=True),
    "init_no_skip": dict(init_image=True),
    "clip_denoised_fn_cond_fn": dict(clip_denoised=True, denoised_fn=True, cond_fn=True),
}


@pytest.mark.parametrize("case", list(DDPM_CASES))
def test_p_sample_loop_matches_jax(case):
    import jax

    from oakink2_tamf_tpu.core import diffusion as JD

    jmodel, jcond, jden = _jax_fns()
    sp, sj = _scheds()
    kw = dict(DDPM_CASES[case])
    skip = kw.get("skip_timesteps", 0)
    init = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32) if kw.get("init_image") else None
    jkw = dict(kw, init_image=init, denoised_fn=jden if kw.get("denoised_fn") else None,
               cond_fn=jcond if kw.get("cond_fn") else None)
    pkw = dict(kw, init_image=None if init is None else _t(init),
               denoised_fn=denoised_fn if kw.get("denoised_fn") else None,
               cond_fn=cond_fn if kw.get("cond_fn") else None)
    key = jax.random.PRNGKey(11)
    want = JD.p_sample_loop(jmodel, sj, SHAPE, key, **jkw)
    x_t, steps = _chain_noise(key, T - skip)
    got = D.p_sample_loop(model_fn, sp, SHAPE, device="cpu", noise=x_t, step_noise=steps, **pkw)
    _close(got, want)


@pytest.mark.parametrize("dump_steps", [None, (0, 7, 29, 49)])
def test_p_sample_loop_trajectory_matches_jax(dump_steps):
    import jax

    from oakink2_tamf_tpu.core import diffusion as JD

    jmodel, _, _ = _jax_fns()
    sp, sj = _scheds()
    key = jax.random.PRNGKey(5)
    want = JD.p_sample_loop_trajectory(jmodel, sj, SHAPE, key, dump_steps=dump_steps, with_pred_xstart=True)
    x_t, steps = _chain_noise(key, T)
    got = D.p_sample_loop_trajectory(model_fn, sp, SHAPE, device="cpu", noise=x_t, step_noise=steps,
                                     dump_steps=dump_steps, with_pred_xstart=True)
    assert set(got) == set(want) == {"sample", "trajectory", "pred_xstart"}
    n = T if dump_steps is None else len(dump_steps)
    assert tuple(got["trajectory"].shape) == tuple(got["pred_xstart"].shape) == (n,) + SHAPE
    for k in got:
        _close(got[k], want[k])
    if dump_steps is None:  # the last state is the sample; the loop returns it too
        assert torch.equal(got["trajectory"][-1], got["sample"])
        assert torch.equal(got["sample"], D.p_sample_loop(model_fn, sp, SHAPE, device="cpu", noise=x_t,
                                                           step_noise=steps))


# ---------------------------------------------------------------------------
# DDIM and PLMS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("guided", [False, True])
def test_ddim_matches_jax(eta, guided):
    import jax

    from oakink2_tamf_tpu.core import diffusion as JD

    jmodel, jcond, jden = _jax_fns()
    sp, sj = _scheds()
    key = jax.random.PRNGKey(21)
    jkw = dict(clip_denoised=True, denoised_fn=jden, cond_fn=jcond) if guided else {}
    pkw = dict(clip_denoised=True, denoised_fn=denoised_fn, cond_fn=cond_fn) if guided else {}
    want = JD.ddim_sample_loop(jmodel, sj, SHAPE, key, eta=eta, **jkw)
    x_t, steps = _chain_noise(key, T)
    got = D.ddim_sample_loop(model_fn, sp, SHAPE, device="cpu", noise=x_t, eta=eta,
                             step_noise=steps if eta > 0 else None, **pkw)
    _close(got, want)


def test_ddim_eta_zero_draws_no_step_noise():
    """At eta 0 DDIM is deterministic in x_T: the generator is not touched
    after x_T, and a step_noise passed anyway changes nothing."""
    sp = D.tamf_schedule(T)
    g = torch.Generator().manual_seed(0)
    a = D.ddim_sample_loop(model_fn, sp, SHAPE, device="cpu", generator=g)
    after = torch.randn(3, generator=g)
    g2 = torch.Generator().manual_seed(0)
    x_t = torch.randn(SHAPE, generator=g2)
    assert torch.equal(torch.randn(3, generator=g2), after)
    b = D.ddim_sample_loop(model_fn, sp, SHAPE, device="cpu", noise=x_t,
                           step_noise=torch.randn((T,) + SHAPE))
    assert torch.equal(a, b)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_plms_matches_jax(order):
    import jax

    from oakink2_tamf_tpu.core import diffusion as JD

    jmodel, _, _ = _jax_fns()
    sp, sj = _scheds()
    key = jax.random.PRNGKey(31 + order)
    want = JD.plms_sample_loop(jmodel, sj, SHAPE, key, order=order, clip_denoised=order == 3)
    x_t, _ = _chain_noise(key, 1)
    got = D.plms_sample_loop(model_fn, sp, SHAPE, device="cpu", noise=x_t, order=order,
                             clip_denoised=order == 3)
    _close(got, want)


def test_plms_counts_model_calls():
    """order > 1: the improved-Euler pair costs one extra call, once."""
    sp = D.tamf_schedule(T)
    seen = []

    def counting(x, t):
        seen.append(int(t[0]))
        return model_fn(x, t)

    D.plms_sample_loop(counting, sp, SHAPE, device="cpu", generator=torch.Generator().manual_seed(0))
    assert seen[:3] == [T - 1, T - 2, T - 2] and len(seen) == T + 1
    with pytest.raises(ValueError, match="order"):
        D.plms_sample_loop(model_fn, sp, SHAPE, device="cpu", order=5)


# ---------------------------------------------------------------------------
# Respaced schedule: every sampler sees the map, looks up the respaced arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "plms", "parallel"])
def test_respaced_schedule_matches_jax(sampler):
    import jax

    from oakink2_tamf_tpu.core import diffusion as JD

    jmodel, _, _ = _jax_fns()
    sp, sj = _scheds("10")
    assert sp.num_timesteps == 10 and sp.timestep_map.tolist() == np.asarray(sj.timestep_map).tolist()
    key = jax.random.PRNGKey(41)
    if sampler == "ddpm":
        want = JD.p_sample_loop(jmodel, sj, SHAPE, key)
        x_t, steps = _chain_noise(key, 10)
        got = D.p_sample_loop(model_fn, sp, SHAPE, device="cpu", noise=x_t, step_noise=steps)
    elif sampler == "ddim":
        want = JD.ddim_sample_loop(jmodel, sj, SHAPE, key, eta=0.5)
        x_t, steps = _chain_noise(key, 10)
        got = D.ddim_sample_loop(model_fn, sp, SHAPE, device="cpu", noise=x_t, step_noise=steps, eta=0.5)
    elif sampler == "plms":
        want = JD.plms_sample_loop(jmodel, sj, SHAPE, key, order=4)
        x_t, _ = _chain_noise(key, 1)
        got = D.plms_sample_loop(model_fn, sp, SHAPE, device="cpu", noise=x_t, order=4)
    else:
        want = JD.p_sample_loop_parallel(jmodel, sj, SHAPE, key, window=4, tol=0.0)
        x_t, zs = _t_noise(key, 10)
        got = D.p_sample_loop_parallel(model_fn, sp, SHAPE, device="cpu", noise=x_t, t_noise=zs,
                                       window=4, tol=0.0)
    _close(got, want)


# ---------------------------------------------------------------------------
# The parallel (Picard) sampler
# ---------------------------------------------------------------------------


def _sequential_pinned(sched, x_t, t_noise):
    """The ancestral chain with the parallel sampler's noise: step t takes t_noise[t]."""
    img = x_t
    for t in reversed(range(sched.num_timesteps)):
        tt = torch.full((SHAPE[0],), t, dtype=torch.int64)
        img = D.p_sample(model_fn, sched, img, tt, t_noise[t])["sample"]
    return img


def test_parallel_tol_zero_is_the_sequential_chain():
    sp = D.tamf_schedule(T)
    g = torch.Generator().manual_seed(0)
    x_t, zs = torch.randn(SHAPE, generator=g), torch.randn((T,) + SHAPE, generator=g)
    out, info = D.p_sample_loop_parallel(model_fn, sp, SHAPE, device="cpu", noise=x_t, t_noise=zs,
                                         window=8, tol=0.0, return_info=True)
    _close(out, _sequential_pinned(sp, x_t, zs))
    assert info == {"n_sweeps": T, "n_model_evals": T * 8}


@pytest.mark.parametrize("window,tol", [(8, 0.0), (16, 1e-2), (64, 1e-2)])
def test_parallel_matches_jax(window, tol):
    """tol 0: 1e-5. tol 1e-2: 1e-4 and the same sweep count. window 64 > T
    is clamped to T on both sides."""
    import jax

    from oakink2_tamf_tpu.core import diffusion as JD

    jmodel, _, _ = _jax_fns()
    sp, sj = _scheds()
    key = jax.random.PRNGKey(1)
    want, jinfo = JD.p_sample_loop_parallel(jmodel, sj, SHAPE, key, window=window, tol=tol,
                                            return_info=True)
    x_t, zs = _t_noise(key, T)
    got, info = D.p_sample_loop_parallel(model_fn, sp, SHAPE, device="cpu", noise=x_t, t_noise=zs,
                                         window=window, tol=tol, return_info=True)
    _close(got, want, ATOL if tol == 0 else 1e-4)
    assert info == {"n_sweeps": int(jinfo["n_sweeps"]), "n_model_evals": int(jinfo["n_model_evals"])}
    assert info["n_model_evals"] == info["n_sweeps"] * min(window, T)
    if tol > 0:
        assert info["n_sweeps"] < T


def test_parallel_guided_matches_jax():
    """cond_fn, denoised_fn and clip_denoised inside the window's one call."""
    import jax

    from oakink2_tamf_tpu.core import diffusion as JD

    jmodel, jcond, jden = _jax_fns()
    sp, sj = _scheds()
    key = jax.random.PRNGKey(2)
    want = JD.p_sample_loop_parallel(jmodel, sj, SHAPE, key, window=16, tol=0.0, cond_fn=jcond,
                                     denoised_fn=jden, clip_denoised=True)
    x_t, zs = _t_noise(key, T)
    got = D.p_sample_loop_parallel(model_fn, sp, SHAPE, device="cpu", noise=x_t, t_noise=zs, window=16,
                                   tol=0.0, cond_fn=cond_fn, denoised_fn=denoised_fn, clip_denoised=True)
    _close(got, want)


def test_parallel_one_model_call_per_sweep_with_window_rows():
    sp = D.tamf_schedule(T)
    calls = []

    def recording(x, t):
        calls.append((x.shape[0], t.tolist()))
        return model_fn(x, t)

    _, info = D.p_sample_loop_parallel(recording, sp, SHAPE, device="cpu",
                                       generator=torch.Generator().manual_seed(0), window=8, tol=1e-2,
                                       return_info=True)
    assert len(calls) == info["n_sweeps"]
    rows, ts = calls[0]
    assert rows == 8 * SHAPE[0]  # [W * bs], window-major
    assert ts == [t for t in range(T - 1, T - 9, -1) for _ in range(SHAPE[0])]


def test_parallel_draws_noise_in_chain_order():
    """Drawn from a generator, the pinned noise of timestep t is the
    (T - t)-th draw after x_T: the tol-0 result equals the sequential chain
    fed those draws."""
    sp = D.tamf_schedule(T)
    out = D.p_sample_loop_parallel(model_fn, sp, SHAPE, device="cpu",
                                   generator=torch.Generator().manual_seed(4), window=8, tol=0.0)
    g = torch.Generator().manual_seed(4)
    x_t = torch.randn(SHAPE, generator=g)
    zs = torch.stack([torch.randn(SHAPE, generator=g) for _ in range(T)]).flip(0)
    _close(out, _sequential_pinned(sp, x_t, zs))


def test_unknown_sampler_and_noise_shape_raise():
    sp = D.tamf_schedule(T)
    with pytest.raises(ValueError, match="unknown sampler"):
        D.sample_loop("euler", model_fn, sp, SHAPE, device="cpu")
    with pytest.raises(ValueError, match="step_noise"):
        D.p_sample_loop(model_fn, sp, SHAPE, device="cpu", step_noise=torch.zeros((T - 1,) + SHAPE))
    with pytest.raises(ValueError, match="t_noise"):
        D.p_sample_loop_parallel(model_fn, sp, SHAPE, device="cpu", t_noise=torch.zeros(SHAPE))


# ---------------------------------------------------------------------------
# On the card: each sampler on CUDA tensors against the CPU, same noise
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "plms", "parallel"])
def test_cuda_sampler_matches_cpu(sampler):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from oakink2_tamf_tpu_torch import _device

    _device.set_fp32_precision()
    sp = D.tamf_schedule(T)
    g = torch.Generator().manual_seed(8)
    noise = {"noise": torch.randn(SHAPE, generator=g)}
    if sampler == "ddpm":
        noise["step_noise"] = torch.randn((T,) + SHAPE, generator=g)
    elif sampler == "parallel":
        noise["t_noise"] = torch.randn((T,) + SHAPE, generator=g)
    cpu = D.sample_loop(sampler, model_fn, sp, SHAPE, device="cpu", noise=noise, parallel_window=8)
    gpu = D.sample_loop(sampler, model_fn, sp.to("cuda"), SHAPE, device="cuda", noise=noise, parallel_window=8)
    assert gpu.is_cuda
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), atol=1e-4)
