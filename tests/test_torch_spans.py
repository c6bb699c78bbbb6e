"""The port's recorder of spans and counters (runtime/profiler.py): off
without a profiler session, on under one, one record per session, on the
profiler's clock; and the spans a G step, an R step and a `generate` call
leave, with the cull mask's counters."""

import os

import numpy as np
import pytest
import torch

from oakink2_tamf_tpu_torch.core import diffusion as D
from oakink2_tamf_tpu_torch.core import geometry as G
from oakink2_tamf_tpu_torch.core import mano as M
from oakink2_tamf_tpu_torch.data.collate import SegmentCollate
from oakink2_tamf_tpu_torch.data.synthetic import SyntheticSegments, synthetic_batch, with_perturbed_sample
from oakink2_tamf_tpu_torch.data.target_cache import TargetH2OCache
from oakink2_tamf_tpu_torch.launch import common
from oakink2_tamf_tpu_torch.models import losses as LL
from oakink2_tamf_tpu_torch.models import mdm_g as MDM
from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig, SegmentRefineNet, stack_mano_models
from oakink2_tamf_tpu_torch.parallel import train as PT
from oakink2_tamf_tpu_torch.runtime import profiler as P
from oakink2_tamf_tpu_torch.serving import TamfPipeline

SMALL = dict(latent_dim=32, ff_size=64, num_layers=1, num_heads=4, dropout=0.0)
STEPS = 3  # diffusion steps of the tiny chain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch single-threaded for this file under pytest-xdist (the workers share the cores)."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    """fn() under a CPU profiler session -> (the session's profile, report())."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof, P.report()


def _nested():
    with P.span("outer", request=5):
        torch.ones(64).sum()
        with P.span("inner", device=True):
            (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
            with P.span("leaf"):
                torch.ones(8).cumsum(0)
        with P.span("inner", device=True):
            torch.zeros(16).add_(1)
        P.count("things", torch.tensor([True, False, True]))
        P.count("things", 4)


# ---------------------------------------------------------------------------
# Off and on
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["span_is_the_shared_noop", "spans_and_counts_record_nothing"])
def test_off_without_a_profiler_session(case):
    if case == "span_is_the_shared_noop":
        assert not P.recording()
        assert P.span("a") is P.span("b", device=True, request=3)
        with P.span("a") as got:
            assert got is None
        return
    _, before = _profiled(_nested)
    _nested()
    after = P.report()
    assert [r.id for r in after.records] == [r.id for r in before.records]
    assert after.counters == before.counters == {"things": 6}


@pytest.mark.parametrize("case", ["parent_and_request", "self_time", "fresh_record_per_session",
                                  "device_span_on_the_cpu_takes_host_time"])
def test_on_under_a_profiler_session(case):
    _, rep = _profiled(_nested)
    recs = rep.records
    by_id = {r.id: r for r in recs}
    if case == "parent_and_request":
        assert [(r.name, r.parent, r.request) for r in recs] == [
            ("outer", None, 5), ("inner", 0, 5), ("leaf", 1, 5), ("inner", 0, 5)]
        for r in recs:
            if r.parent is not None:
                p = by_id[r.parent]
                assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    elif case == "self_time":
        dur = {r.id: (r.end_ns - r.start_ns) * 1e-9 for r in recs}
        assert rep.spans["outer"].n == 1 and rep.spans["inner"].n == 2 and rep.spans["leaf"].n == 1
        assert rep.spans["outer"].host_self_s == pytest.approx(dur[0] - dur[1] - dur[3], abs=1e-12)
        assert rep.spans["inner"].host_s == pytest.approx(dur[1] + dur[3], abs=1e-12)
        assert rep.spans["inner"].host_self_s == pytest.approx(dur[1] - dur[2] + dur[3], abs=1e-12)
        assert rep.spans["leaf"].host_self_s == pytest.approx(dur[2], abs=1e-12)
        assert rep.spans["outer"].device_s is None and rep.spans["leaf"].device_s is None
    elif case == "fresh_record_per_session":
        _, again = _profiled(lambda: P.count("other", 2))
        assert again.records == [] and again.counters == {"other": 2}
        assert rep.counters == {"things": 6}
    else:
        for r in recs:
            if r.name == "inner":
                assert r.events is None and r.device_s == (r.end_ns - r.start_ns) * 1e-9
        assert rep.spans["inner"].device_s == pytest.approx(rep.spans["inner"].host_s)
        assert rep.spans["inner"].device_self_s == pytest.approx(rep.spans["inner"].device_s)


def test_spans_bracket_the_profiler_events_of_their_ops():
    """The records' times are on the clock of the profiler's events: each
    span's [start, end] holds the events of the ops run inside it, and the
    session's trace shows the span itself."""
    prof, rep = _profiled(_nested)
    events = prof.profiler.kineto_results.events()
    ops = [e for e in events if e.name().startswith("aten::")]
    assert ops
    for name, want in (("outer", ("aten::ones", "aten::mm", "aten::cumsum", "aten::add_")),
                       ("leaf", ("aten::cumsum",))):
        (rec,) = [r for r in rep.records if r.name == name]
        inside = {e.name() for e in ops if rec.start_ns <= e.start_ns() and e.end_ns() <= rec.end_ns}
        assert set(want) <= inside, (name, inside)
    (mm,) = [e for e in ops if e.name() == "aten::mm"]
    leaf = next(r for r in rep.records if r.name == "leaf")
    assert not (leaf.start_ns <= mm.start_ns() <= leaf.end_ns)  # mm ran before the leaf span
    assert {"outer", "inner", "leaf"} <= {e.name() for e in events}


# ---------------------------------------------------------------------------
# The spans of a G step, an R step and a generate call
# ---------------------------------------------------------------------------


def _mano():
    return stack_mano_models(M.synthetic_mano_model("right"), M.synthetic_mano_model("left"), "cpu")


def _batch(seed):
    return synthetic_batch(np.random.default_rng(seed), batch_size=2, seq_len=8, max_nobj=2, n_obj_points=128,
                           min_len=4)


def _g_steps(n):
    torch.manual_seed(0)
    model = MDM.InteractionSegmentMDM(MDM.MDMConfig(**SMALL))
    state = PT.TrainState(model, PT.make_optimizer(model.named_parameters()))
    step = PT.make_g_train_step(D.tamf_schedule(50), _mano(), LL.load_contact_assets(), LL.ExtraLossConfig())
    gen = torch.Generator().manual_seed(0)
    batches = [common.device_batch(_batch(i), torch.device("cpu")) for i in range(n)]
    return lambda: [step(state, b, generator=gen) for b in batches]


def _r_steps(n):
    torch.manual_seed(0)
    mano = _mano()
    net = SegmentRefineNet(RefineConfig(**SMALL))
    state = PT.TrainState(net, PT.make_optimizer(net.named_parameters()))
    step = PT.make_r_train_step(mano, LL.load_contact_assets(), LL.RefineLossConfig(), backend="cull", chunk=128)
    base = SyntheticSegments(2 * n, seq_len=32, max_nobj=2, n_obj_points=128, seed=3)  # 16-32 live frames
    collate = SegmentCollate(max_nobj=2, n_obj_points=128)
    cache = TargetH2OCache(base, mano, collate, batch_size=2)
    cache.precompute()
    rng = np.random.default_rng(0)
    batches = [collate([cache[2 * i], cache[2 * i + 1]]) for i in range(n)]
    batches = [common.device_batch(with_perturbed_sample(b, rng), torch.device("cpu")) for b in batches]
    assert all("target_h2o" in b for b in batches)

    def run():
        return [step(state, b) for b in batches]

    # two masks a step, each over the live frames' 2 object slots x 7 hand regions x 1 object tile
    run.blocks_live = sum(2 * 2 * 7 * int(b["mask"].sum()) for b in batches)
    return run


def _generates(n):
    pipe = TamfPipeline.load(g_config=MDM.MDMConfig(**SMALL), r_config=RefineConfig(**SMALL),
                             diffusion_steps=STEPS, device="cpu", batch_size=2, seq_len=16, max_nobj=2,
                             n_obj_points=128)
    segments = [SyntheticSegments(2, seq_len=16, max_nobj=2, n_obj_points=128)[i] for i in range(2)]
    gen = torch.Generator().manual_seed(0)
    pipe.generate(segments, generator=gen)  # call 0, outside the session
    return lambda: [pipe.generate(segments, generator=gen) for _ in range(n)]


def _children(rep, parent_name):
    ids = {r.id for r in rep.records if r.name == parent_name}
    return [r.name for r in rep.records if r.parent in ids]


@pytest.mark.parametrize("kind", ["g_step", "r_step", "generate"])
def test_the_program_spans_and_counts_per_step(kind, monkeypatch):
    monkeypatch.setattr(G, "CULL_MIN_P2", 128)  # generate's R takes the cull route at the tiny cloud size
    n = 2
    run = {"g_step": _g_steps, "r_step": _r_steps, "generate": _generates}[kind](n)
    _, rep = _profiled(run)
    spans, recs = rep.spans, rep.records
    top = [r for r in recs if r.parent is None]
    if kind == "g_step":
        steps = [r for r in top if r.name == "train.g_step"]
        assert [r.request for r in steps] == [0, 1]
        assert _children(rep, "train.g_step") == n * ["g.gt_geometry", "g.trunk_loss", "g.extra_loss",
                                                      "train.backward", "train.optimizer"]
        assert spans["mano.recover"].n == 2 * n and spans["mano.normals"].n == 2 * n
        assert "cull.mask" not in spans and rep.counters == {}
    elif kind == "r_step":
        steps = [r for r in top if r.name == "train.r_step"]
        assert [r.request for r in steps] == [0, 1]
        assert _children(rep, "train.r_step") == n * ["r.target_geometry", "r.sample_geometry", "r.net",
                                                      "r.refined_geometry", "r.loss", "train.backward",
                                                      "train.optimizer"]
        assert spans["mano.recover"].n == 3 * n and spans["cull.mask"].n == 2 * n
        kept, live = rep.counters["cull.blocks_kept"], rep.counters["cull.blocks_live"]
        assert live == run.blocks_live < 2 * n * 2 * 32 * 2 * 7 and 0 < kept <= live
    else:
        calls = [r for r in top if r.name == "serve.generate"]
        assert [r.request for r in calls] == [1, 2]
        assert _children(rep, "serve.generate") == n * ["serve.collate_h2d", "serve.g_chain", "serve.refine",
                                                         "serve.d2h"]
        assert _children(rep, "serve.g_chain") == n * STEPS * ["diffusion.step"]
        assert spans["diffusion.step"].n == n * STEPS
        assert spans["mano.recover"].n == 2 * n and spans["cull.mask"].n == 2 * n
        assert _children(rep, "serve.refine") == n * ["r.sample_geometry", "r.net", "r.refined_geometry"]
        assert 0 < rep.counters["cull.blocks_kept"] <= rep.counters["cull.blocks_live"]
    assert all(r.request is not None for r in recs if r.name != "batch.h2d")
    for name in ("mano.recover", "cull.mask", "train.backward", "serve.refine"):
        if name in spans:
            t = spans[name]
            assert t.device_s is not None and 0 < t.device_self_s <= t.device_s
