"""The learned-variance, KL and other mean-type branches of the port's
diffusion engine (oakink2_tamf_tpu_torch/core/diffusion.py) against the
JAX package's, on the CPU, with the same numpy inputs and pinned noise.

Stand-in models: x -> 0.9 x + 0.01 t for C channels, and x -> [0.9 x +
0.01 t | tanh(x)] for the 2C channels of a learned variance. At t = 0 it
predicts x_0 to within a few posterior deviations, as a trained model
does: the decoder NLL there is then well conditioned in float32 (both
sides within ~1e-6 of float64). A poor predictor (0.3 x) puts that term in
the float32 tails of the discretised CDF, where each side lies up to 5%
from its own float64 value.

Tolerances, float32 on both sides, as tests/test_diffusion.py:448-660
justifies them against the reference:
- p_mean_variance, q_mean_variance, the x_0 identities and the KL pieces:
  rtol 1e-5 / atol 1e-6 (the same float32 formulas);
- the variational terms at t > 0: rtol 5e-4 / atol 1e-4; the t = 0
  decoder NLL divides by a near-zero posterior standard deviation, so that
  term and `total_bpd` are held at rtol 2e-2;
- the chains (DDPM, DDIM, PLMS with the JAX chain's noise) on the x_0
  predictor tanh(0.9 x + 0.1 sin t) of tests/test_torch_samplers.py, put
  in each mean type's own output (the noise or the posterior mean it
  implies): atol 1e-4; an EPSILON step recovers x_0 through
  1/sqrt(alpha_bar), ~3e2 at the first step of T = 20.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from oakink2_tamf_tpu.core import diffusion as JD
from oakink2_tamf_tpu_torch.core import diffusion as D

T = 20
BS, L, C = 3, 7, 5
MEAN_TYPES = ("START_X", "EPSILON", "PREVIOUS_X")
VAR_TYPES = ("FIXED_SMALL", "FIXED_LARGE", "LEARNED", "LEARNED_RANGE")
LEARNED = ("LEARNED", "LEARNED_RANGE")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(a) -> np.ndarray:
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _models(learned: bool):
    """(port model_fn, JAX model_fn): 0.9 x + 0.01 t, and with a learned
    variance the variance half tanh(x)."""
    def tfn(x, t):
        m = 0.9 * x + 0.01 * t.to(torch.float32)[:, None, None]
        return torch.cat([m, torch.tanh(x)], dim=-1) if learned else m

    def jfn(x, t):
        m = 0.9 * x + 0.01 * t.astype(jnp.float32)[:, None, None]
        return jnp.concatenate([m, jnp.tanh(x)], axis=-1) if learned else m

    return tfn, jfn


def _scheds():
    betas = D.get_named_beta_schedule("cosine", T)
    return D.make_schedule(betas), JD.make_schedule(betas)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(BS, L, C)).astype(np.float32)
    noise = rng.normal(size=(BS, L, C)).astype(np.float32)
    mask = (rng.random((BS, L)) > 0.25).astype(np.float32)
    return x, noise, mask


@pytest.mark.parametrize("var_type", VAR_TYPES)
@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_p_mean_variance_matches_jax(mean_type, var_type):
    ts, js = _scheds()
    x, _, _ = _inputs(1)
    t = np.array([0, 7, T - 1])
    tfn, jfn = _models(var_type in LEARNED)
    kw = dict(model_mean_type=getattr(D.ModelMeanType, mean_type), model_var_type=getattr(D.ModelVarType, var_type))
    jkw = dict(model_mean_type=getattr(JD.ModelMeanType, mean_type),
               model_var_type=getattr(JD.ModelVarType, var_type))
    got = D.p_mean_variance(tfn, ts, _t(x), _t(t), **kw)
    want = JD.p_mean_variance(jfn, js, jnp.asarray(x), jnp.asarray(t), **jkw)
    for k in ("mean", "variance", "log_variance", "pred_xstart", "model_output"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    # clip_denoised and denoised_fn act on the predicted x_0 of every mean type
    got = D.p_mean_variance(tfn, ts, _t(3 * x), _t(t), clip_denoised=True, denoised_fn=lambda a: 2 * a, **kw)
    want = JD.p_mean_variance(jfn, js, jnp.asarray(3 * x), jnp.asarray(t), clip_denoised=True,
                              denoised_fn=lambda a: 2 * a, **jkw)
    for k in ("mean", "pred_xstart"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_learned_variance_needs_twice_the_channels():
    ts, _ = _scheds()
    x = torch.zeros(BS, L, C)
    tfn, _ = _models(False)
    with pytest.raises(ValueError, match=f"{2 * C} channels"):
        D.p_mean_variance(tfn, ts, x, torch.zeros(BS, dtype=torch.int64),
                          model_var_type=D.ModelVarType.LEARNED_RANGE)


def test_q_mean_variance_xprev_and_kl_pieces_match_jax():
    ts, js = _scheds()
    x, noise, _ = _inputs(2)
    t = np.array([1, 9, T - 1])
    for a, b in zip(D.q_mean_variance(ts, _t(x), _t(t)), JD.q_mean_variance(js, jnp.asarray(x), jnp.asarray(t))):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(D.predict_xstart_from_xprev(ts, _t(x), _t(t), _t(noise))),
        _np(JD.predict_xstart_from_xprev(js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))),
        rtol=1e-5, atol=1e-5,
    )
    lv1, lv2 = 0.5 * noise, -0.3 * x
    np.testing.assert_allclose(_np(D.normal_kl(_t(x), _t(lv1), _t(noise), _t(lv2))),
                               _np(JD.normal_kl(x, lv1, noise, lv2)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(D.approx_standard_normal_cdf(_t(3 * x))),
                               _np(JD.approx_standard_normal_cdf(jnp.asarray(3 * x))), rtol=1e-5, atol=1e-6)
    xe = np.clip(x, -1.0, 1.0)
    xe[0, 0] = (-1.0, 1.0, -0.9995, 0.9995, 0.0)  # both open edge bins and the inner rule
    # means within ~1 standard deviation (~0.02) of x: bins away from the float32 tails
    means, log_scales = xe + 0.02 * noise, -4.0 + 0.1 * x
    np.testing.assert_allclose(
        _np(D.discretized_gaussian_log_likelihood(_t(xe), means=_t(means), log_scales=_t(log_scales))),
        _np(JD.discretized_gaussian_log_likelihood(jnp.asarray(xe), means=jnp.asarray(means),
                                                   log_scales=jnp.asarray(log_scales))),
        rtol=1e-4, atol=1e-5,
    )
    for f, jf in ((D.sum_flat, JD.sum_flat), (D.mean_flat, JD.mean_flat)):
        np.testing.assert_allclose(_np(f(_t(x))), _np(jf(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(_np(D.prior_bpd(ts, _t(x))), _np(JD.prior_bpd(js, jnp.asarray(x))), rtol=1e-5)


def _vb_close(got, want, t):
    """Per-sample variational terms: t > 0 at rtol 5e-4 / atol 1e-4, t = 0 at 2e-2."""
    got, want = _np(got), _np(want)
    late = t > 0
    np.testing.assert_allclose(got[late], want[late], rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(got[~late], want[~late], rtol=2e-2)


@pytest.mark.parametrize("loss_type", ["MSE", "RESCALED_MSE", "KL", "RESCALED_KL"])
@pytest.mark.parametrize("mean_type", ["START_X", "EPSILON"])
def test_training_losses_learned_range_matches_jax(loss_type, mean_type):
    """Every loss type with LEARNED_RANGE: the loss, and with an MSE loss the
    frozen-mean vb term, which carries no gradient into the mean half."""
    ts, js = _scheds()
    x, noise, mask = _inputs(3)
    t = np.array([0, 5, T - 1])
    tfn, jfn = _models(True)
    kw = dict(model_mean_type=getattr(D.ModelMeanType, mean_type), model_var_type=D.ModelVarType.LEARNED_RANGE,
              loss_type=getattr(D.LossType, loss_type))
    loss, aux = D.training_losses(tfn, ts, _t(x), _t(t), _t(mask), noise=_t(noise), **kw)
    jkw = dict(model_mean_type=getattr(JD.ModelMeanType, mean_type), model_var_type=JD.ModelVarType.LEARNED_RANGE,
               loss_type=getattr(JD.LossType, loss_type))
    jloss, jaux = JD.training_losses(jfn, js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask), None,
                                     noise=jnp.asarray(noise), **jkw)
    np.testing.assert_allclose(_np(aux["x_t"]), _np(jaux["x_t"]), rtol=1e-6, atol=1e-6)
    if loss_type.endswith("KL"):
        assert set(aux) == {"x_t", "pred_xstart"}
        _vb_close(loss, jloss, t)
        np.testing.assert_allclose(_np(aux["pred_xstart"]), _np(jaux["pred_xstart"]), rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-5, atol=1e-6)
    for k in ("model_output", "target"):
        np.testing.assert_allclose(_np(aux[k]), _np(jaux[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    _vb_close(aux["vb"], jaux["vb"], t)

    scale = torch.tensor(1.0, requires_grad=True)
    var_scale = torch.tensor(1.0, requires_grad=True)
    _, aux = D.training_losses(
        lambda xx, tt: torch.cat([scale * 0.3 * xx, var_scale * torch.tanh(xx)], dim=-1),
        ts, _t(x), _t(t), _t(mask), noise=_t(noise), **kw)
    aux["vb"].sum().backward()
    assert scale.grad is None or float(scale.grad) == 0.0
    assert var_scale.grad is not None and float(var_scale.grad) != 0.0


@pytest.mark.parametrize("mean_type", ["EPSILON", "PREVIOUS_X"])
def test_training_losses_mse_targets_match_jax(mean_type):
    ts, js = _scheds()
    x, noise, mask = _inputs(4)
    t = np.array([0, 11, T - 1])
    tfn, jfn = _models(False)
    loss, aux = D.training_losses(tfn, ts, _t(x), _t(t), _t(mask), noise=_t(noise),
                                  model_mean_type=getattr(D.ModelMeanType, mean_type))
    jloss, jaux = JD.training_losses(jfn, js, jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask), None,
                                     noise=jnp.asarray(noise), model_mean_type=getattr(JD.ModelMeanType, mean_type))
    np.testing.assert_allclose(_np(loss), _np(jloss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(aux["target"]), _np(jaux["target"]), rtol=1e-5, atol=1e-6)
    assert "vb" not in aux


@pytest.mark.parametrize("mean_type", ["START_X", "EPSILON"])
def test_calc_bpd_loop_matches_jax(mean_type):
    ts, js = _scheds()
    x, _, _ = _inputs(5)
    x = np.clip(0.5 * x, -1.0, 1.0)
    noise = np.random.default_rng(6).normal(size=(T,) + x.shape).astype(np.float32)
    tfn, jfn = _models(False)
    got = D.calc_bpd_loop(tfn, ts, _t(x), noise=_t(noise), model_mean_type=getattr(D.ModelMeanType, mean_type))
    jmt = getattr(JD.ModelMeanType, mean_type)
    want = JD.calc_bpd_loop(jfn, js, jnp.asarray(x), None, noise=jnp.asarray(noise), model_mean_type=jmt)
    for k in ("vb", "xstart_mse", "mse"):
        assert got[k].shape == (BS, T), k
        a, b = _np(got[k]), _np(want[k])
        np.testing.assert_allclose(a[:, :-1], b[:, :-1], rtol=5e-4, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(a[:, -1], b[:, -1], rtol=2e-2, err_msg=f"{k} (t = 0 column)")
    np.testing.assert_allclose(_np(got["prior_bpd"]), _np(want["prior_bpd"]), rtol=1e-5)
    np.testing.assert_allclose(_np(got["total_bpd"]), _np(want["total_bpd"]), rtol=2e-2)
    # without pinned noise the loop draws the T steps' noise from the generator, in chain order
    g = torch.Generator().manual_seed(0)
    drawn = torch.stack([torch.randn(x.shape, generator=g) for _ in range(T)])
    g.manual_seed(0)
    a = D.calc_bpd_loop(tfn, ts, _t(x), generator=g)
    b = D.calc_bpd_loop(tfn, ts, _t(x), noise=drawn)
    assert torch.equal(a["vb"], b["vb"])


def _chain_noise(key, n_steps, shape):
    """(x_T, step_noise [n_steps, ...]) as the JAX DDPM and DDIM chains draw them."""
    key, k_init = jax.random.split(key)
    x_t = jax.random.normal(k_init, shape, jnp.float32)
    steps = [jax.random.normal(k, shape, jnp.float32) for k in jax.random.split(key, n_steps)]
    return _t(np.asarray(x_t)), _t(np.stack([np.asarray(s) for s in steps]))


CHAINS = {
    "ddpm_eps": ("ddpm", "EPSILON", "FIXED_SMALL"),
    "ddpm_eps_learned_range": ("ddpm", "EPSILON", "LEARNED_RANGE"),
    "ddpm_prev_x_fixed_large": ("ddpm", "PREVIOUS_X", "FIXED_LARGE"),
    "ddim_eps": ("ddim", "EPSILON", "FIXED_SMALL"),
    "plms_eps": ("plms", "EPSILON", "FIXED_SMALL"),
}


def _chain_models(mean_type: str, learned: bool, sched):
    """(port, JAX) model_fn whose implied x_0 is tanh(0.9 x + 0.1 sin t), as
    the mean type's output: x_0 itself, the noise, or the posterior mean;
    with a learned variance the variance half tanh(x)."""
    ab = sched.alphas_cumprod.numpy()
    c1, c2 = sched.posterior_mean_coef1.numpy(), sched.posterior_mean_coef2.numpy()

    def output(x, x0, col):
        if mean_type == "EPSILON":
            return (x - col(ab) ** 0.5 * x0) / (1 - col(ab)) ** 0.5
        if mean_type == "PREVIOUS_X":
            return col(c1) * x0 + col(c2) * x
        return x0

    def tfn(x, t):
        x0 = torch.tanh(0.9 * x + 0.1 * torch.sin(t.to(torch.float32))[:, None, None])
        out = output(x, x0, lambda a: torch.from_numpy(a)[t][:, None, None])
        return torch.cat([out, torch.tanh(x)], dim=-1) if learned else out

    def jfn(x, t):
        x0 = jnp.tanh(0.9 * x + 0.1 * jnp.sin(t.astype(jnp.float32))[:, None, None])
        out = output(x, x0, lambda a: jnp.take(jnp.asarray(a), t)[:, None, None])
        return jnp.concatenate([out, jnp.tanh(x)], axis=-1) if learned else out

    return tfn, jfn


@pytest.mark.parametrize("case", list(CHAINS))
def test_chains_at_other_mean_types_match_jax(case):
    sampler, mean_type, var_type = CHAINS[case]
    ts, js = _scheds()
    shape = (2, 6, C)
    tfn, jfn = _chain_models(mean_type, var_type in LEARNED, ts)
    key = jax.random.PRNGKey(7)
    x_t, steps = _chain_noise(key, T, shape)
    mt, vt = getattr(D.ModelMeanType, mean_type), getattr(D.ModelVarType, var_type)
    jmt, jvt = getattr(JD.ModelMeanType, mean_type), getattr(JD.ModelVarType, var_type)
    if sampler == "ddpm":
        got = D.p_sample_loop(tfn, ts, shape, device="cpu", noise=x_t, step_noise=steps,
                              model_mean_type=mt, model_var_type=vt)
        want = JD.p_sample_loop(jfn, js, shape, key, model_mean_type=jmt, model_var_type=jvt)
        via_loop = D.sample_loop("ddpm", tfn, ts, shape, device="cpu", noise={"noise": x_t, "step_noise": steps},
                                 model_mean_type=mt, model_var_type=vt)
        assert torch.equal(via_loop, got)
    elif sampler == "ddim":
        got = D.ddim_sample_loop(tfn, ts, shape, device="cpu", noise=x_t, model_mean_type=mt)
        want = JD.ddim_sample_loop(jfn, js, shape, key, model_mean_type=jmt)
    else:
        got = D.plms_sample_loop(tfn, ts, shape, device="cpu", noise=x_t, model_mean_type=mt)
        want = JD.plms_sample_loop(jfn, js, shape, key, model_mean_type=jmt)
        with pytest.raises(ValueError, match="model_var_type"):
            D.sample_loop("plms", tfn, ts, shape, device="cpu", model_var_type=D.ModelVarType.LEARNED)
    assert float(got.abs().max()) < 10.0
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
