"""The harness finds a cell, a configuration, a traffic mix, an entry and a
per-layer metric from new files alone, and refuses what it must."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness
from benchmark.tests.tiny import ROOT

MADE_UP_ENTRY = '''
import torch

from ..lib import work
from . import common


def run(ctx):
    n, m = common.drive(ctx, lambda i: torch.ones(8, device=ctx.device).sum())
    return {"attempted": n, "failed": 0, "e2e": {"made_up_per_s": n / ctx.window.seconds},
            "checks": [("made_up_gap", 0.5 * ctx.limits["made_up_gap"], ctx.limits["made_up_gap"])],
            "layer": {"work_flops": work.search(1, int(ctx.cfg["points"]))}, "traced": {"steps": m}}
'''

MADE_UP_READER = '''
def read(run):
    return run.layer["work_flops"] / 8.0
'''

SCRIPT = '''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from benchmark import harness
spec = harness.load_cell(sys.argv[1], "made_up.cell")
out = [harness.execute(spec, 5, 0.01, trace, torch.device("cpu"), time.perf_counter()) for trace in (False, True)]
print(json.dumps(out))
'''


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["oakink2_tamf_tpu_torch.ops", "oakink2_tamf_tpu_torch", "jaxtyping", "flaxen", "numpy.jax",
            "oakink2_tamf_tpu.core.mano", "jax", "optax.transform", "jaxlib.xla_client"]
    assert harness.forbidden_modules(mods) == ["jax", "jaxlib.xla_client", "oakink2_tamf_tpu.core.mano",
                                               "optax.transform"]


def test_a_new_cell_config_mix_and_metric_come_from_new_files_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    (b / "configs" / "made_up.json").write_text(json.dumps({"points": 100}))
    (b / "traffic" / "made_up_mix.json").write_text(json.dumps({"entry": "made_up_entry"}))
    (b / "entries" / "made_up_entry.py").write_text(MADE_UP_ENTRY)
    (b / "limits" / "made_up.cell.json").write_text(json.dumps({"made_up_gap": 1e-3}))
    (b / "layer_metrics" / "made_up_metric.py").write_text(MADE_UP_READER)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "made_up", "source": "https://example.org/made-up",
                             "file": "benchmark/configs/made_up.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "made_up.cell", "config": "made_up", "traffic": "made_up_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "made_up_per_s", "unit": "1/s", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["made_up.cell"]})
    bench["per_layer"].append({"name": "made_up_metric", "unit": "pairs", "better": "higher",
                               "source": "program_counter", "layer": "made up", "moves": "made_up_per_s",
                               "workloads": ["made_up.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(plain["metrics"]) == {"made_up_per_s", "setup_s"}
    assert traced["metrics"] == {"made_up_metric": {"value": 100 * 778, "unit": "pairs"}}
    assert plain["correct"] and traced["correct"]
    assert list(plain)[-1] == "checks" and plain["checks"]["made_up_gap"]["limit"] == 1e-3


MADE_UP_RANK_ENTRY = '''
import torch
import torch.distributed as dist


def run(ctx):
    def step(i):
        x = torch.full((4,), float(ctx.rank + 1), device=ctx.device)
        dist.all_reduce(x)
        got.append(float(x[0]))

    got = []
    n, m = common.drive(ctx, step)
    want = ctx.world * (ctx.world + 1) / 2
    gap = max(abs(v - want) for v in got)
    return {"attempted": n, "failed": 0, "e2e": {"made_up_per_s": ctx.world * n / ctx.window.seconds},
            "checks": [("sum_gap", gap + ctx.rank * 1e-9, ctx.limits["sum_gap"])],
            "layer": {"work_flops": float(n)}, "traced": {}}


from . import common  # noqa: E402
'''

RANKS_SCRIPT = '''
import sys, time
sys.path.insert(0, sys.argv[1])
from benchmark import harness
sys.exit(harness.run_ranks(["--workload", "made_up.ranks", "--seed", str(2**31 + 7), "--seconds", "0.2",
                            "--trace", "0"], 2, time.perf_counter(), rank_device="cpu"))
'''


def test_a_cell_of_two_chips_runs_as_two_ranks_from_new_files_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    (b / "configs" / "made_up.json").write_text(json.dumps({}))
    (b / "traffic" / "made_up_ranks.json").write_text(json.dumps({"entry": "made_up_ranks"}))
    (b / "entries" / "made_up_ranks.py").write_text(MADE_UP_RANK_ENTRY)
    (b / "limits" / "made_up.ranks.json").write_text(json.dumps({"sum_gap": 1e-6}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "made_up", "source": "https://example.org/made-up",
                             "file": "benchmark/configs/made_up.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "made_up.ranks", "config": "made_up", "traffic": "made_up_ranks",
                               "chips": 2, "why": "a test"})
    bench["end_to_end"].append({"name": "made_up_per_s", "unit": "1/s", "better": "higher", "bound": 0.1,
                                "source": "host_clock", "workloads": ["made_up.ranks"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", RANKS_SCRIPT, str(tmp_path)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=180, env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["count"] == 2 and r["attempted"] > 0
    assert set(r["metrics"]) == {"made_up_per_s", "setup_s"}
    assert r["checks"]["sum_gap"]["value"] == 1e-9  # the worse rank's reading
    assert out.stderr.strip().splitlines()[-1].startswith("check sum_gap")
    assert not [p for p in os.listdir(tmp_path) if p.startswith("bench-ranks-")]  # the hand-off is removed


def test_a_failing_rank_fails_the_run_and_ends_the_others(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "benchmark"
    (b / "configs" / "made_up.json").write_text(json.dumps({}))
    (b / "traffic" / "made_up_ranks.json").write_text(json.dumps({"entry": "made_up_ranks"}))
    (b / "entries" / "made_up_ranks.py").write_text(
        "import torch.distributed as dist\n\n\ndef run(ctx):\n"
        "    if ctx.rank == 1:\n        raise SystemExit(3)\n    dist.barrier()\n")
    (b / "limits" / "made_up.ranks.json").write_text(json.dumps({}))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "made_up", "source": "https://example.org/made-up",
                             "file": "benchmark/configs/made_up.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "made_up.ranks", "config": "made_up", "traffic": "made_up_ranks",
                               "chips": 2, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", RANKS_SCRIPT, str(tmp_path)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=180, env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode != 0 and out.stdout == ""
    assert "rank(s) [1] of 2 failed" in out.stderr or "rank(s) [0, 1] of 2 failed" in out.stderr


def test_every_cell_finds_its_files_and_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        spec = harness.load_cell(ROOT, cell["name"])
        assert os.path.isfile(os.path.join(harness.HERE, "entries", f"{spec['traffic']['entry']}.py"))
        e2e = {m["name"] for m in harness.cell_metrics(bench, cell["name"], False)}
        layer = harness.cell_metrics(bench, cell["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e
            assert callable(harness.load_reader(m["name"]))


def test_the_run_refuses_without_a_card_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "g_mdm_l.train_fused", "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_the_run_refuses_without_the_program(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    script = ("import sys, time; sys.path[0] = sys.argv[1]; import torch; torch.cuda.is_available = lambda: True; "
              "torch.cuda.device_count = lambda: 1; from benchmark.harness import main; "
              "sys.exit(main(['--workload', 'g_mdm_l.train_fused', '--seed', '1', '--seconds', '1'], "
              "sys.argv[1], time.perf_counter()))")
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "not in this checkout" in out.stderr


def test_a_mix_may_lengthen_the_window():
    import re
    import time

    import torch

    from benchmark.tests.tiny import tiny_spec

    torch.set_num_threads(2)
    spec = tiny_spec("r_refine.train_cull")
    spec["traffic"]["min_seconds"] = 0.5
    lines = []
    r = harness.execute(spec, 2**31 + 29, 0.01, False, torch.device("cpu"), time.perf_counter(), lines.append)
    window = float(re.search(r"window_s ([0-9.]+)", "\n".join(lines)).group(1))
    assert r["correct"] and window >= 0.5
