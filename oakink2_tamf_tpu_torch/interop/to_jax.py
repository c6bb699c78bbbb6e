"""This port's G, R and FID-encoder state_dicts -> the JAX package's flax
variables, and a port TrainState -> the flat dict the JAX package's
runtime/ckpt.save_checkpoint writes for its TrainState.

The inverse of interop/from_jax (a copy of what the JAX package's
interop/torch_port does, which the port does not import): Linear weight
[out, in] -> Dense kernel [in, out]; packed in_proj [3d, d] -> per-head
q/k/v kernels [d, heads, head_dim]; out_proj [d, d] -> out kernel
[heads, head_dim, d]; LayerNorm weight -> scale. Pure rearrangements, so a
round trip through from_jax gives every value back bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..models.encoder import SegmentEncoder
from ..models.mdm_g import InteractionSegmentMDM
from ..models.refine_r import SegmentRefineNet


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _a(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _lin(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"bias": _a(sd[f"{prefix}.bias"]), "kernel": _a(sd[f"{prefix}.weight"].T)}


def _ln(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"bias": _a(sd[f"{prefix}.bias"]), "scale": _a(sd[f"{prefix}.weight"])}


def _attn(sd: Mapping[str, np.ndarray], prefix: str, heads: int) -> dict:
    w, b = sd[f"{prefix}.in_proj_weight"], sd[f"{prefix}.in_proj_bias"]
    d = w.shape[1]
    hd = d // heads
    out = {n: {"bias": _a(bi.reshape(heads, hd)), "kernel": _a(wi.T.reshape(d, heads, hd))}
           for n, wi, bi in zip(("query", "key", "value"), np.split(w, 3, axis=0), np.split(b, 3, axis=0))}
    out["out"] = {"bias": _a(sd[f"{prefix}.out_proj.bias"]),
                  "kernel": _a(sd[f"{prefix}.out_proj.weight"].T.reshape(heads, hd, d))}
    return out


def _trunk(sd: Mapping[str, np.ndarray], prefix: str, heads: int) -> dict:
    n = len({k.split(".")[2] for k in sd if k.startswith(f"{prefix}.layers.")})
    return {
        f"layer_{i}": {
            "linear1": _lin(sd, f"{prefix}.layers.{i}.linear1"),
            "linear2": _lin(sd, f"{prefix}.layers.{i}.linear2"),
            "norm1": _ln(sd, f"{prefix}.layers.{i}.norm1"),
            "norm2": _ln(sd, f"{prefix}.layers.{i}.norm2"),
            "self_attn": _attn(sd, f"{prefix}.layers.{i}.self_attn", heads),
        }
        for i in range(n)
    }


def _cond_trunk(sd: Mapping[str, np.ndarray], heads: int) -> dict:
    return {
        "hand_shape_process": {"shape_embed": _lin(sd, "hand_shape_process.shape_embed")},
        "input_merge": {"merge0": _lin(sd, "input_merge.0"), "merge1": _lin(sd, "input_merge.2")},
        "input_process": {"poseEmbedding": _lin(sd, "input_process.poseEmbedding")},
        "obj_embed_process": {"embedding": _lin(sd, "obj_embed_process.embedding")},
        "obj_input_process": {"poseEmbedding": _lin(sd, "obj_input_process.poseEmbedding")},
        "seqTransEncoder": _trunk(sd, "seqTransEncoder", heads),
    }


def g_flax_from_state_dict(sd: Mapping[str, np.ndarray], heads: int) -> dict:
    """InteractionSegmentMDM state_dict -> JAX InteractionSegmentMDM variables."""
    p = _cond_trunk(sd, heads)
    p["embed_text"] = _lin(sd, "embed_text")
    p["embed_timestep"] = {"time_embed_0": _lin(sd, "embed_timestep.time_embed.0"),
                           "time_embed_1": _lin(sd, "embed_timestep.time_embed.2")}
    p["output_process"] = {"poseFinal": _lin(sd, "output_process.poseFinal")}
    return {"params": p}


def r_flax_from_state_dict(sd: Mapping[str, np.ndarray], heads: int) -> dict:
    """SegmentRefineNet state_dict -> JAX SegmentRefineNet variables."""
    p = _cond_trunk(sd, heads)
    p["h2o_dist_input_process"] = {"poseEmbedding": _lin(sd, "h2o_dist_input_process.poseEmbedding")}
    p["output_process"] = {"poseFinal": _lin(sd, "output_process.poseFinal")}
    return {"params": p}


def encoder_flax_from_state_dict(sd: Mapping[str, np.ndarray], heads: int) -> dict:
    """SegmentEncoder state_dict -> JAX SegmentEncoder variables (params
    and the `buffers` collection's classification_token)."""
    p = _cond_trunk(sd, heads)
    p["output_process"] = {f"fc{i}": _lin(sd, f"output_process.poseFinal.{2 * i}") for i in range(3)}
    return {"buffers": {"classification_token": _a(sd["classification_token"])}, "params": p}


_CONVERTERS = (
    (InteractionSegmentMDM, g_flax_from_state_dict),
    (SegmentRefineNet, r_flax_from_state_dict),
    (SegmentEncoder, encoder_flax_from_state_dict),
)


def flax_variables(module: torch.nn.Module, sd: Mapping[str, torch.Tensor]) -> dict:
    """`sd` (keys of `module`'s state_dict) as the JAX package's variables
    of the same model (G, R or the FID encoder, by the module's class)."""
    for cls, fn in _CONVERTERS:
        if isinstance(module, cls):
            return fn({k: _np(v) for k, v in sd.items()}, module.cfg.num_heads)
    raise TypeError(f"no JAX checkpoint converter for {type(module).__name__}: one of "
                    f"{[c[0].__name__ for c in _CONVERTERS]}")


def _flatten(tree: Mapping[str, Any], prefix: str, out: dict) -> dict:
    for k in sorted(tree):  # jax.tree_util's order: dict keys sorted
        v = tree[k]
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v
    return out


def train_state_flat(state) -> dict[str, np.ndarray]:
    """A port TrainState (parallel/train.py) in the flat layout the JAX
    package's save_checkpoint writes for its TrainState(step, params,
    opt_state) under make_optimizer's optax chain: "0" the step, "1/..."
    the variables, "2/1/0/{count,mu,nu}" scale_by_adam's state,
    "2/1/2/count" scale_by_schedule's (per_param_clip and
    add_decayed_weights hold none); float32 arrays and int32 counts. The
    moments of a parameter AdamW has not stepped, and of buffers, are 0
    (what optax holds for a zero gradient)."""
    model, opt = state.model, state.optimizer
    sd = model.state_dict()
    names = {id(p): n for n, p in model.named_parameters()}
    mu = {k: torch.zeros_like(v) for k, v in sd.items()}
    nu = {k: torch.zeros_like(v) for k, v in sd.items()}
    count = 0
    for p in opt.params:
        st = opt.adamw.state.get(p)
        if st:
            mu[names[id(p)]], nu[names[id(p)]] = st["exp_avg"], st["exp_avg_sq"]
            count = int(st["step"])
    flat = {"0": np.asarray(state.step, np.int32)}
    _flatten(flax_variables(model, sd), "1/", flat)
    flat["2/1/0/count"] = np.asarray(count, np.int32)
    _flatten(flax_variables(model, mu), "2/1/0/mu/", flat)
    _flatten(flax_variables(model, nu), "2/1/0/nu/", flat)
    flat["2/1/2/count"] = np.asarray(opt.scheduler.last_epoch, np.int32)
    return flat
