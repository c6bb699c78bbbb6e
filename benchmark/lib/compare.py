"""The numbers that decide `correct`, each against its limit.

Training: each step's loss as a relative gap; the first gradient as the
optimizer got it (AdamW's first moment after one step over 1 - beta1) and
the parameters' change after three steps, each by the worst leaf: the gap
between the two sides' norms of a leaf over the reference's norm of that
leaf or of the median leaf, whichever is larger. A leaf is a parameter,
except that attention's packed in-projection is its query, key and value
blocks. The change leaves out the
leaves whose reference gradient is under a thousandth of the median leaf's
(their moves are AdamW's sign of rounding noise).

Answers checked one by one: the largest absolute difference of each
returned array.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3
PACKED_QKV = ("in_proj_weight", "in_proj_bias")


def leaves(named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The parameters at the configuration's granularity: attention's packed
    query, key and value projections are three leaves (as the optimizer
    clips them)."""
    out = {}
    for k, v in named.items():
        if k.endswith(PACKED_QKV):
            for tag, part in zip("qkv", v.chunk(3, dim=0)):
                out[f"{k}[{tag}]"] = part
        else:
            out[k] = v
    return out


def _norms(d: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def worst_leaf_gap(prog: dict, ref: dict) -> tuple[float, str]:
    """(max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖), that leaf)."""
    keys = sorted(ref)
    np_, nr = _norms({k: prog[k] for k in keys}), _norms(ref)
    med = statistics.median(nr.values())
    return max((abs(np_[k] - nr[k]) / max(nr[k], med), k) for k in keys)


def moving_leaves(ref_grad: dict) -> set:
    nr = _norms(ref_grad)
    med = statistics.median(nr.values())
    return {k for k, v in nr.items() if v >= NEGLIGIBLE_GRAD * med}


def loss_gap(prog: list[float], ref: list[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def max_abs(a, b) -> float:
    return float(torch.max(torch.abs(torch.as_tensor(a).double() - torch.as_tensor(b).double())))


def first_gradients(adamw: torch.optim.Optimizer, named: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The gradient each parameter got at AdamW's first step, from its state
    (zero where the optimizer holds none: it took no step)."""
    beta1 = adamw.param_groups[0]["betas"][0]
    state = adamw.state
    return {k: (state[p]["exp_avg"] / (1.0 - beta1)).detach().clone() if "exp_avg" in state.get(p, {})
            else torch.zeros_like(p.detach()) for k, p in named.items()}


def train_checks(prog: dict, ref: dict, limits: dict, notes: list | None = None) -> list[tuple[str, float, float]]:
    """prog, ref: {"losses": [..], "p0": {..}, "g1": {..}, "p3": {..}} with
    `p0` the common start. -> [(name, value, limit)]; the worst leaves go to
    `notes`."""
    pg, rg, p0, pp3, rp3 = (leaves(d) for d in (prog["g1"], ref["g1"], ref["p0"], prog["p3"], ref["p3"]))
    keep = moving_leaves(rg)
    grad, grad_leaf = worst_leaf_gap(pg, rg)
    change, change_leaf = worst_leaf_gap({k: pp3[k] - p0[k] for k in keep}, {k: rp3[k] - p0[k] for k in keep})
    if notes is not None:
        notes.append(f"worst leaves: grad {grad_leaf}, change {change_leaf} ({len(rg) - len(keep)} of "
                     f"{len(rg)} leaves left out of the change)")
    return [
        ("loss_gap", loss_gap(prog["losses"], ref["losses"]), limits["loss_gap"]),
        ("grad_gap", grad, limits["grad_gap"]),
        ("change_gap", change, limits["change_gap"]),
    ]
