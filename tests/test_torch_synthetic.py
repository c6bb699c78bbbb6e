"""data/synthetic.with_perturbed_sample of the port against the JAX
package's, on the same synthetic batch and generator seed.

Tolerance: atol 1e-6 (the same numpy draws; the rot6d renormalization's
norms round differently in torch and XLA); padded frames exactly 0 on both
sides."""

import numpy as np
import pytest

from oakink2_tamf_tpu.data import synthetic as JS
from oakink2_tamf_tpu_torch.data import synthetic as S


@pytest.mark.parametrize("seed,sigma_range", [(0, (0.02, 0.1)), (5, (0.3, 0.5))])
def test_with_perturbed_sample_matches_jax(seed, sigma_range):
    batch = S.synthetic_batch(np.random.default_rng(seed), batch_size=3, seq_len=12, max_nobj=2, n_obj_points=32,
                              min_len=4)
    jbatch = JS.synthetic_batch(np.random.default_rng(seed), batch_size=3, seq_len=12, max_nobj=2,
                                n_obj_points=32, min_len=4, as_jax=False)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    rng, jrng = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    got = S.with_perturbed_sample(batch, rng, sigma_range)
    want = JS.with_perturbed_sample(jbatch, jrng, sigma_range)
    assert rng.random() == jrng.random()  # the same draws, in the same order
    sp, jsp = got["sample_pose_repr"], np.asarray(want["sample_pose_repr"])
    assert sp.dtype == np.float32 and sp.shape == batch["pose_repr"].shape
    np.testing.assert_allclose(sp, jsp, rtol=0, atol=1e-6)
    pad = batch["mask"] == 0
    assert pad.any() and np.all(sp[pad] == 0.0) and np.all(jsp[pad] == 0.0)
    assert not np.allclose(sp[~pad], batch["pose_repr"][~pad], atol=1e-3)  # perturbed where valid
    rot = sp[~pad][:, 3:].reshape(-1, 16, 2, 3)
    np.testing.assert_allclose(np.linalg.norm(rot, axis=-1), 1.0, atol=1e-5)  # unit rot6d columns
    assert got["pose_repr"] is batch["pose_repr"] and "sample_pose_repr" not in batch
