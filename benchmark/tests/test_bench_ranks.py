"""The cell of several chips at a tiny size on two gloo ranks on the CPU, each
rank a process of its own: it is correct, and each fault of its exchange
planted underneath comes out not correct, in a run and in control.py's
readings. The readers that depend on the
cell's chips: `allreduce_ms.train` on a made-up trace, `mfu.train` over the
cards' peak."""

import pytest

from benchmark import harness
from benchmark.lib.trace import TraceSummary
from benchmark.tests.tiny import run_tiny_ranks, spawn_ranks, tiny_spec

CELL = "g_mdm_l.train_fused_4gpu"


def test_the_four_card_cell_is_correct_on_two_gloo_ranks():
    r = run_tiny_ranks(CELL, trace=True)
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 2 and 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for name in ("idle_share.train", "mfu.train", "mano_fwd_ms.train", "h2d_ms.train", "allreduce_ms.train"):
        assert r["metrics"][name]["value"] > 0, name
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["no_allreduce", "half_batch", "state_unchanged"])
def test_a_broken_step_on_two_ranks_is_not_correct(fault):
    r = run_tiny_ranks(CELL, fault=fault)
    assert not r["correct"], r["checks"]


def test_summed_gradients_on_two_ranks_are_not_correct():
    """With the clip raised out of the way: under the configuration's clip
    of 0.1 every leaf of the tiny model is clipped, and AdamW's step is
    free of the gradient's scale, so a sum in place of the mean changes
    nothing that the step produces."""
    r = run_tiny_ranks(CELL, fault="sum_allreduce", train={"grad_clip": 1e6})
    assert not r["correct"], r["checks"]
    assert r["checks"]["grad_gap"]["value"] > 0.5


def _control(device, group, seeds, faults) -> dict:
    import importlib

    import torch.distributed as dist

    from benchmark import control

    entry = importlib.import_module("benchmark.entries.train_g")
    calls, reference = [], entry.reference

    def counted(ctx, *a, **kw):
        calls.append(ctx.seed)
        return reference(ctx, *a, **kw)

    entry.reference = counted
    lines = control.readings(tiny_spec(CELL), seeds, 0.05, faults, device, dist.get_rank(), dist.get_world_size(),
                             group)
    return {"lines": lines, "calls": calls}


def test_control_reads_the_sound_program_and_each_fault_against_one_reference():
    """Per seed: the sound program within the limits, with the control's and
    the half batch's readings; the exchange left out beyond them; the
    reference run three times (float32, the control, half batch) and kept
    for the fault's run."""
    from benchmark import control

    seed = 2**31 + 17
    lim = tiny_spec(CELL)["limits"]
    per_rank = spawn_ranks(_control, 2, "cpu", [seed], [None, "no_allreduce"])
    for got in per_rank:
        assert got["calls"] == [seed] * 3
    sound, broken = (control.worst([got["lines"][i] for got in per_rank]) for i in range(2))
    assert (sound["fault"], broken["fault"]) == (None, "no_allreduce")
    assert all(v <= lim[n] for n, v in sound["program"].items()), sound
    assert set(sound) >= {"control", "half_batch"} and "control" not in broken
    assert any(v > lim[n] for n, v in broken["program"].items()), broken


def _run(kernels: dict, steps: int, chips: int, **kw) -> harness.Run:
    trace = TraceSummary(window_s=1.0, busy_s=0.5, kernels=kernels, device_ops=[], idle_gaps=[], n_kernels=0)
    return harness.Run(window_s=2.0, trace=trace, memory_peak=0, layer=kw.get("layer", {}),
                       traced={"steps": steps}, power_limit_w=None, chips=chips)


def test_allreduce_reads_nccl_kernel_time_per_step():
    read = harness.load_reader("allreduce_ms.train")
    kernels = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": [0.018, 10],
               "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)": [0.002, 20],
               "nn_signed_kernel": [1.0, 10]}
    assert read(_run(kernels, 10, 4)) == pytest.approx(2.0)
    with pytest.raises(RuntimeError):
        read(_run({"ncclDevKernel_AllReduce_Sum_f32_RING_LL": [0.018, 9]}, 10, 4))
    with pytest.raises(RuntimeError):
        read(_run({"nn_signed_kernel": [1.0, 10]}, 10, 4))
    assert read(_run(kernels, 10, 1)) is None
    assert read(harness.Run(window_s=2.0, trace=None, memory_peak=0, layer={}, traced={}, power_limit_w=None,
                            chips=4)) is None


def test_mfu_holds_the_groups_work_against_every_cards_peak():
    from benchmark.lib.peaks import FP32_FLOPS

    read = harness.load_reader("mfu.train")
    layer = {"work_flops": 0.5 * FP32_FLOPS}
    assert read(_run({}, 1, 1, layer=layer)) == pytest.approx(25.0)
    assert read(_run({}, 1, 4, layer=layer)) == pytest.approx(6.25)
