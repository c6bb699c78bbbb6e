"""The readers of the program's spans and counters: on a tiny traced run of
each cell, on the CPU, each returns a finite number, and it raises where the
program's step count and the traced window's disagree."""

import math

import pytest

from benchmark import harness
from benchmark.tests.tiny import run_tiny

READERS = {
    "g_mdm_l.train_fused": ("mano_fwd_ms.train", "h2d_ms.train"),
    "r_refine.train_cull": ("mano_fwd_ms.train", "h2d_ms.train", "cull_mask_ms.train", "cull_kept_share.train"),
    "g_mdm_l.sample_ddpm": ("refine_ms.sample", "host_ms_per_gstep.sample"),
}


@pytest.mark.parametrize("cell", list(READERS))
def test_the_span_readers_read_a_tiny_traced_cell(cell, monkeypatch):
    from oakink2_tamf_tpu_torch.core import geometry

    # the tiny clouds (256 points) take the cull route, as the cells' 8192 do
    monkeypatch.setattr(geometry, "CULL_MIN_P2", 128)
    r = run_tiny(cell, trace=True)
    assert r["correct"]
    for name in READERS[cell]:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, name
    if cell == "r_refine.train_cull":
        assert r["metrics"]["cull_kept_share.train"]["value"] <= 100.0

    # the program's record of the traced window stays until the next session
    from oakink2_tamf_tpu_torch.runtime.profiler import report

    spans = report().spans
    if cell == "g_mdm_l.sample_ddpm":
        traced = {"g_steps": spans["diffusion.step"].n}
    else:
        traced = {"steps": sum(spans[s].n for s in ("train.g_step", "train.r_step") if s in spans)}
    for name in READERS[cell]:
        read = harness.load_reader(name)
        good = harness.Run(window_s=1.0, trace=object(), memory_peak=0, layer={}, traced=traced, power_limit_w=None)
        assert read(good) == pytest.approx(r["metrics"][name]["value"]), name
        off = {k: v + 1 for k, v in traced.items()}
        with pytest.raises(RuntimeError):
            read(harness.Run(window_s=1.0, trace=object(), memory_peak=0, layer={}, traced=off, power_limit_w=None))
