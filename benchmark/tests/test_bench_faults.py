"""A run whose timed path is broken underneath comes out not correct: once for
each fault its cell can have (none of the cells spans chips, so the
exchange between chips has no fault to plant). The runs skip the harness's
look for a chip and drive the rest of a run on the CPU at a tiny size,
against the cells' own limits."""

import numpy as np
import pytest

from benchmark.tests.tiny import run_tiny

TRAIN = ("g_mdm_l.train_fused", "r_refine.train_cull")


def _unchanged(monkeypatch):
    from oakink2_tamf_tpu_torch.parallel import train as PT

    monkeypatch.setattr(PT, "_step", lambda state: None)


def _half_batch(monkeypatch):
    from oakink2_tamf_tpu_torch.parallel import train as PT

    for name in ("make_g_train_step", "make_r_train_step"):
        make = getattr(PT, name)

        def faulty(*a, _make=make, **kw):
            step = _make(*a, **kw)

            def half(state, batch, **skw):
                n = batch["mask"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()}, **skw)

            return half

        monkeypatch.setattr(PT, name, faulty)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(cell)
    assert not r["correct"], r["checks"]


def test_an_altered_answer_is_not_correct(monkeypatch):
    from oakink2_tamf_tpu_torch import serving

    run = serving.TamfPipeline._run

    def altered(self, batch, generator, noise):
        out = run(self, batch, generator, noise)
        out["refine_pose_repr"] = out["refine_pose_repr"].clone()
        out["refine_pose_repr"][0, 0, 0] += 1e-2
        return out

    monkeypatch.setattr(serving.TamfPipeline, "_run", altered)
    r = run_tiny("g_mdm_l.sample_ddpm")
    assert not r["correct"], r["checks"]
    assert r["checks"]["refine_gap"]["value"] > r["checks"]["refine_gap"]["limit"]
    assert np.isfinite(r["checks"]["g_sample_gap"]["value"])
