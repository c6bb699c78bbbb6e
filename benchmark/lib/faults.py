"""Faults planted in the program underneath a run: the control's readings of
them (benchmark/control.py --faults) and the tests that see `correct` come
out false. Each takes `patch(obj, name, value)` (setattr, or pytest's
monkeypatch.setattr) and patches the port's train step in this process, so
a rank plants its own. The benchmark's own runs never plant one."""

from __future__ import annotations


def state_unchanged(patch) -> None:
    """A step that returns its state unchanged: no exchange, no update."""
    from oakink2_tamf_tpu_torch.parallel import train as PT

    patch(PT, "_step", lambda state: None)


def half_batch(patch) -> None:
    """A step on the first half of its batch's rows, its means over them."""
    from oakink2_tamf_tpu_torch.parallel import train as PT

    for name in ("make_g_train_step", "make_r_train_step"):
        make = getattr(PT, name)

        def faulty(*a, _make=make, **kw):
            step = _make(*a, **kw)

            def half(state, batch, **skw):
                n = batch["mask"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()}, **skw)

            return half

        patch(PT, name, faulty)


def no_allreduce(patch) -> None:
    """The exchange between chips left out: each rank steps on its own gradient."""
    from oakink2_tamf_tpu_torch.parallel import mesh

    patch(mesh, "all_reduce_grads_", lambda params: None)


def sum_allreduce(patch) -> None:
    """The ranks' gradients summed where the program takes their mean."""
    import torch.distributed as dist

    from oakink2_tamf_tpu_torch.parallel import mesh

    def summed(params):
        for p in params:
            if p.requires_grad and p.grad is not None:
                dist.all_reduce(p.grad)

    patch(mesh, "all_reduce_grads_", summed)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, no_allreduce, sum_allreduce)}
