"""A run whose timed path is broken underneath comes out not correct: once for
each fault its cell can have (lib/faults.py; the faults of the exchange
between chips are test_bench_ranks.py's). The runs skip the harness's look
for a chip and drive the rest of a run on the CPU at a tiny size, against
the cells' own limits."""

import numpy as np
import pytest

from benchmark.lib import faults
from benchmark.tests.tiny import run_tiny

TRAIN = ("g_mdm_l.train_fused", "r_refine.train_cull")


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
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
