"""What the entries share: the run's context, the program's MANO and contact
assets built from the benchmark's arrays, the models with the benchmark's
weights, and the reference's counterparts."""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from ..lib import assets as A
from ..lib import weights
from ..lib.trace import Window


@dataclasses.dataclass
class Context:
    cfg: dict  # the configuration file
    traffic: dict  # the traffic mix's parameters
    limits: dict  # the cell's limits on the compared numbers
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: bool = False  # also read the control and the planted faults (benchmark/control.py)
    rank: int = 0  # this process's rank in a cell of several chips (benchmark/lib/ranks.py)
    world: int = 1
    host_group: Any = None  # the ranks' gloo group, on which rank 0's clock closes every rank's window
    marks: list = dataclasses.field(default_factory=list)  # (set-up phase, host clock at its end)
    notes: list = dataclasses.field(default_factory=list)  # lines for standard error

    def __post_init__(self):
        self.window = Window(self.device, trace=False)
        self.traced = Window(self.device, trace=True) if self.trace else None

    def mark(self, phase: str) -> None:
        """Note the end of a set-up phase (printed on standard error)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.marks.append((phase, time.perf_counter()))


TRACE_SECONDS = 10.0  # the traced window; a longer one only lengthens reading the trace


def drive(ctx: Context, step, before_trace=lambda: None) -> tuple[int, int]:
    """Calls step(i), i counting on from 0, in the timed window until
    --seconds have passed; then, with --trace, `before_trace()` and the next
    steps in a traced window of TRACE_SECONDS (or --seconds, if shorter),
    so that no number of the timed window is read under the profiler. Returns the number of steps in each window. Across ranks,
    rank 0's clock decides for all after each step, over the host group,
    so that every rank takes the same steps and no device waits on it."""
    n = _loop(ctx, ctx.window, step, 0, ctx.seconds)
    ctx.notes.append(f"timed window: {n} steps in {ctx.window.seconds:.4f} s")
    if not ctx.trace:
        return n, 0
    before_trace()
    m = _loop(ctx, ctx.traced, step, n, min(ctx.seconds, TRACE_SECONDS))
    ctx.notes.append(f"traced window: {m} steps in {ctx.traced.seconds:.4f} s")
    return n, m


def _loop(ctx: Context, w: Window, step, i0: int, seconds: float) -> int:
    w.start()
    i = i0
    while True:
        step(i)
        i += 1
        done = w.elapsed() >= seconds
        if ctx.world > 1:
            import torch.distributed as dist

            flag = torch.tensor([done], dtype=torch.int32)
            dist.broadcast(flag, 0, group=ctx.host_group)
            done = bool(flag[0])
        if done:
            break
    w.stop()
    return i - i0


def data_params(cfg: dict, traffic: dict) -> dict:
    """The generator's parameters: the configuration's data widths and the
    mix's sizes (`length_quantiles`, `obj_counts`)."""
    d = cfg["data"]
    return {"seq_len": d["seq_len"], "max_nobj": d["max_nobj"], "n_obj_points": d["n_obj_points"],
            "min_len": d["min_len"], "n_prompts": traffic.get("n_prompts", 7),
            "length_quantiles": traffic["length_quantiles"], "obj_counts": traffic["obj_counts"]}


def program_mano(device):
    from oakink2_tamf_tpu_torch.core import mano as M
    from oakink2_tamf_tpu_torch.models.refine_r import stack_mano_models

    rh, lh = A.mano_pair()
    return stack_mano_models(M.ManoModel(**rh), M.ManoModel(**lh), device)


def program_assets(device):
    from oakink2_tamf_tpu_torch.models import losses as LL

    a = A.contact_assets(A.synthetic_mano("right")["faces"])
    return LL.ContactAssets(*(torch.from_numpy(a[k]).to(device) for k in ("vpe", "v_weights", "v_weights2")))


def model_kwargs(model_cfg: dict, fields) -> dict[str, Any]:
    return {k: v for k, v in model_cfg.items() if k in fields}


def program_g(cfg: dict, seed: int, device):
    from oakink2_tamf_tpu_torch.models.mdm_g import InteractionSegmentMDM, MDMConfig

    with torch.device(device):
        m = InteractionSegmentMDM(MDMConfig(**model_kwargs(cfg["g_model"], MDMConfig.__dataclass_fields__)))
    weights.fill(m.to(device), seed, "g_weights")
    return m


def program_r(cfg: dict, seed: int, device):
    from oakink2_tamf_tpu_torch.models.refine_r import RefineConfig, SegmentRefineNet

    with torch.device(device):
        m = SegmentRefineNet(RefineConfig(**model_kwargs(cfg["r_model"], RefineConfig.__dataclass_fields__)))
    weights.fill(m.to(device), seed, "r_weights")
    return m


def reference_g(cfg: dict, seed: int, device):
    from ..reference.mdm_g import InteractionSegmentMDM, MDMConfig

    with torch.device(device):
        m = InteractionSegmentMDM(MDMConfig(**model_kwargs(cfg["g_model"], MDMConfig.__dataclass_fields__)))
    weights.fill(m.to(device), seed, "g_weights")
    return m


def reference_r(cfg: dict, seed: int, device):
    from ..reference.refine_net import RefineConfig, SegmentRefineNet

    with torch.device(device):
        m = SegmentRefineNet(RefineConfig(**model_kwargs(cfg["r_model"], RefineConfig.__dataclass_fields__)))
    weights.fill(m.to(device), seed, "r_weights")
    return m


def free_device(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def named_clone(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def host_batches(segs: list[dict], bs: int) -> list[list[dict]]:
    return [segs[i : i + bs] for i in range(0, len(segs), bs)]



class tf32:
    """Matmuls and convolutions in TF32 inside the block: the control's
    precision, one step below the configurations' float32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def half_batch(batch: dict, shards: int = 1) -> dict:
    """The first half of the rows of each of `shards` equal blocks of the
    batch (a rank's rows in a cell of several chips): the fault of a step
    that leaves half of its batch out and takes its means over the rest."""
    n = len(batch["mask"]) // shards
    return {k: np.concatenate([v[s * n : s * n + n // 2] for s in range(shards)]) for k, v in batch.items()}


def rank_rows(batch: dict, rank: int, rows: int) -> dict:
    """Rows [rank*rows, (rank+1)*rows) of a global batch: a rank's share, as
    the program's mesh.shard_rows cuts it."""
    return {k: v[rank * rows : (rank + 1) * rows] for k, v in batch.items()}


def dropout_tag(step: int, rank: int) -> str:
    """The tag of the dropout seed of a checked step on a rank (rank 0's is
    the tag of one chip's step)."""
    return f"dropout{step}" if rank == 0 else f"dropout{step}.rank{rank}"


def control_readings(ref_fn, ref, checks_fn, faults=()) -> dict:
    """The compared numbers of the reference in TF32 in the program's place,
    and of each planted fault (name -> keyword arguments of ref_fn)."""
    with tf32():
        out = {"control": checks_fn(ref_fn(), ref)}
    for name, kw in faults:
        out[name] = checks_fn(ref_fn(**kw), ref)
    return out
