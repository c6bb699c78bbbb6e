"""The data-parallel process group (port of oakink2_tamf_tpu/parallel/mesh.py).

The JAX package runs one 1-D data mesh under GSPMD: the batch is sharded
over the devices, the parameters are replicated, and the gradient
all-reduce lives inside the compiled step, so W devices compute what one
device computes on the whole global batch. The port runs one process per
device in a torch.distributed group. Each rank holds b rows of a global
batch of W*b (the loader's stripe, data/loader.py), and the train steps
(parallel/train.py) keep the JAX package's global-batch semantics with the
helpers here:

- `all_reduce_grads_` after backward(), before the clip: one flattened
  buffer per dtype, summed over the ranks and divided by W. Parameters
  without a gradient on a rank count as zeros there; a parameter keeps no
  gradient only where no rank had one. Models are not wrapped in
  DistributedDataParallel: their state_dict keys stay the reference's, an
  unused parameter cannot stall a step, and torch.utils.checkpoint needs
  nothing more.
- `shard_rows` cuts this rank's rows out of a draw over the global batch
  (the step's timesteps and q_sample noise; `global_randn` draws the
  samplers' noise so in the eval pass), `all_gather_rows` puts per-row
  values back together, `reduce_metrics` and `reduce_batch_means` reduce
  scalars as means or sums, `all_reduce_max` takes a maximum over the
  ranks (the parallel sampler's slide).

Every helper is the identity when no group is live. `is_coordinator()` (rank
0) gates the side effects: checkpoints, summaries, the file log, traces.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Mapping

import torch
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=10)


def is_live() -> bool:
    """True when this process belongs to an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_live() else 1


def rank() -> int:
    return dist.get_rank() if is_live() else 0


def is_coordinator() -> bool:
    """Rank 0 (or the only process) writes checkpoints, summaries and logs."""
    return rank() == 0


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """The device this process runs on. "cuda" without an index means the
    card of this process's LOCAL_RANK (the current card when LOCAL_RANK is
    unset); "cuda:N" and "cpu" are taken as given. Raises when CUDA is asked
    for and absent, or when LOCAL_RANK has no card."""
    from .._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        lr, count = int(os.environ["LOCAL_RANK"]), torch.cuda.device_count()
        if not 0 <= lr < count:
            raise RuntimeError(
                f"LOCAL_RANK {lr} has no CUDA device ({count} visible): start at most one process "
                "per card, or name a card with --runtime.device cuda:N"
            )
        dev = torch.device("cuda", lr)
    return dev


def init_distributed(*, backend: str, init_method: str, world_size: int, rank: int,
                     device: torch.device | None = None,
                     timeout: datetime.timedelta = _TIMEOUT) -> None:
    """Join the process group. NCCL needs this rank's card selected first, so
    a CUDA `device` becomes the current card. A failed rendezvous raises."""
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)


def _comm_device() -> torch.device:
    """Where a collective's host-made tensor must live: the current card
    under NCCL, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows [r*b, (r+1)*b) of a tensor over the global batch of
    W*b rows. Raises when the rows do not divide evenly."""
    W = world_size()
    if W == 1:
        return x
    n = x.shape[0]
    if n % W:
        raise ValueError(f"{n} rows do not split evenly over {W} ranks")
    b = n // W
    r = rank()
    return x[r * b : (r + 1) * b]


def global_randn(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """This rank's rows of one standard normal float32 draw of W*shape[0]
    rows from `generator`: the draw one process makes on the global batch,
    one step at a time (a sampler's draw function, core/diffusion.py). With
    one process it is that draw, bit for bit."""
    shape = tuple(shape)
    full = (world_size() * shape[0],) + shape[1:]
    return shard_rows(torch.randn(full, generator=generator, device=device, dtype=torch.float32))


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of x over the ranks (x itself without a
    group), on x's device."""
    if not is_live():
        return x
    y = x.detach().to(_comm_device(), copy=True)
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y.to(x.device)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-shaped tensors concatenated along dim 0 in rank
    order: the global batch's rows, on every rank."""
    if not is_live():
        return x
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def all_reduce_grads_(params: Iterable[torch.Tensor]) -> None:
    """Replace each parameter's .grad by its mean over the ranks, in place.

    One all-reduce per gradient dtype over one flat buffer, which also
    carries a flag per parameter: a parameter without a gradient on a rank
    adds zeros there, and gets the mean wherever any rank had one. Every
    rank ends with the same bits. Where every gradient is there, nothing
    waits for the card (no host-made tensor, no read-back) and the copy
    back is one foreach launch: a host sync here would expose the launches
    of the optimizer that follows."""
    if not is_live():
        return
    W = world_size()
    params = [p for p in params if p.requires_grad]
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for p in params:
        groups.setdefault(p.grad.dtype if p.grad is not None else p.dtype, []).append(p)
    for dtype, ps in groups.items():
        missing = [i for i, p in enumerate(ps) if p.grad is None]
        flags = torch.ones(len(ps), dtype=dtype, device=ps[0].device)
        if missing:
            flags[missing] = 0
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p, dtype=dtype)).reshape(-1)
                          for p in ps] + [flags])
        dist.all_reduce(flat)
        n = flat.numel() - len(ps)
        flat[:n].div_(W)
        means = [g.view_as(p) for p, g in zip(ps, torch.split(flat[:n], [p.numel() for p in ps]))]
        present = [i for i in range(len(ps)) if ps[i].grad is not None]
        torch._foreach_copy_([ps[i].grad for i in present], [means[i] for i in present])
        if missing:
            had = flat[n:].tolist()  # a host sync, only on a rank that lacks a gradient
            for i in missing:
                if had[i] > 0:
                    ps[i].grad = means[i].clone()


def reduce_metrics(metrics: Mapping[str, torch.Tensor], kinds: Mapping[str, str]) -> dict[str, torch.Tensor]:
    """The step's 0-d metrics reduced over the ranks: `kinds[name]` "sum"
    for a sum over the batch, "mean" (the default) for a batch mean. Other
    entries pass through. One all-reduce."""
    out = dict(metrics)
    if not is_live():
        return out
    names = [k for k, v in metrics.items() if v.ndim == 0]
    if not names:
        return out
    vals = torch.stack([metrics[k].to(torch.float32) for k in names])
    dist.all_reduce(vals)
    W = world_size()
    for k, v in zip(names, vals):
        kind = kinds.get(k, "mean")
        if kind not in ("mean", "sum"):
            raise ValueError(f"metric {k}: kind {kind!r} is not 'mean' or 'sum'")
        out[k] = (v if kind == "sum" else v / W).to(metrics[k].dtype)
    return out


def reduce_batch_means(acc: Mapping[str, list[float]], sums: Iterable[str] = ()) -> dict[str, float]:
    """An eval pass's per-batch values (acc[name] = one float per local
    batch) as means over the global batches. Each rank's stripe has as many
    batches of the same sizes (the loader's wrap-pad), so global batch i is
    the ranks' batch i together: a batch mean is meaned over the ranks'
    batches, and a batch sum (a name in `sums`) is summed over the ranks
    before the mean over batches."""
    names = sorted(acc)
    sums = set(sums)
    local = [(float(sum(acc[k])), float(len(acc[k]))) for k in names]
    if not is_live():
        return {k: s / n for k, (s, n) in zip(names, local) if n}
    buf = torch.tensor(local, dtype=torch.float64, device=_comm_device())
    dist.all_reduce(buf)
    W = world_size()
    out = {}
    for k, (s, n) in zip(names, buf.tolist()):
        if n:
            out[k] = s / (n / W) if k in sums else s / n
    return out


def barrier() -> None:
    if is_live():
        dist.barrier()
