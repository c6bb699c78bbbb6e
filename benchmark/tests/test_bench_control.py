"""The control comes out not correct: the reference computed in TF32 in the
program's place reads above the limits, at a size a test run holds, on
three seeds. Needs the card (TF32 exists only there), and the cell of four
chips four cards: run on the chip with

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -p no:cacheprovider
"""

import pytest
import torch

from benchmark.tests.tiny import CELLS, shrink, spawn_ranks

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)


def _small(cell):
    from benchmark.harness import load_cell
    from benchmark.tests.tiny import ROOT

    spec = shrink(load_cell(ROOT, cell))
    cfg = spec["cfg"]
    for k in ("g_model", "r_model"):
        if k in cfg:
            cfg[k].update(latent_dim=256, ff_size=1024, num_layers=4)
    cfg["train"]["batch_size"] = 8
    cfg["data"].update(seq_len=64, max_nobj=4, n_obj_points=2048, min_len=16)
    spec["traffic"].update(length_quantiles=[16, 64], obj_counts=[1, 2, 3, 4])
    if "diffusion" in cfg:
        cfg["diffusion"]["steps"] = 200
    return spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_one_of_the_numbers(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    import importlib

    from benchmark.entries.common import Context

    spec = _small(cell)
    entry = importlib.import_module(f"benchmark.entries.{spec['traffic']['entry']}")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for seed in SEEDS:
        ctx = Context(cfg=spec["cfg"], traffic=spec["traffic"], limits=spec["limits"], seed=seed, seconds=0.1,
                      trace=False, device=torch.device("cuda", 0), control=True)
        out = entry.run(ctx)
        assert all(v <= lim for _, v, lim in out["checks"]), out["checks"]
        assert any(v > lim for _, v, lim in out["readings"]["control"]), out["readings"]["control"]


def _readings(device, group, spec, seeds):
    import torch.distributed as dist

    from benchmark import control

    return control.readings(spec, seeds, 0.1, [None], device, dist.get_rank(), dist.get_world_size(), group)


@pytest.mark.cuda
def test_the_control_of_the_four_card_cell_fails_one_of_the_numbers():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs: one rank a card, and TF32 exists only on the card")
    from benchmark import control

    spec = _small("g_mdm_l.train_fused_4gpu")
    lim = spec["limits"]
    per_rank = spawn_ranks(_readings, 4, "cuda", spec, SEEDS)
    for i in range(len(SEEDS)):
        line = control.worst([lines[i] for lines in per_rank])
        assert all(v <= lim[n] for n, v in line["program"].items()), line
        assert any(v > lim[n] for n, v in line["control"].items()), line
