"""The control comes out not correct: the reference computed in TF32 in the
program's place reads above the limits, at a size a test run holds, on
three seeds. Needs the card (TF32 exists only there): run on the chip with

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -p no:cacheprovider
"""

import pytest
import torch

from benchmark.tests.tiny import CELLS, shrink


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
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        ctx = Context(cfg=spec["cfg"], traffic=spec["traffic"], limits=spec["limits"], seed=seed, seconds=0.1,
                      trace=False, device=torch.device("cuda", 0), control=True)
        out = entry.run(ctx)
        assert all(v <= lim for _, v, lim in out["checks"]), out["checks"]
        assert any(v > lim for _, v, lim in out["readings"]["control"]), out["readings"]["control"]
