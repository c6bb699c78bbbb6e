"""Flax parameter trees of the JAX package -> this port's state_dicts.

Input: the JAX models' param trees as nested dicts of numpy arrays (the
`params` collection or the whole variables dict). Output: state_dicts of
`models/mdm_g.InteractionSegmentMDM`, `models/refine_r.SegmentRefineNet`,
`models/encoder.SegmentEncoder`, `models/clip_text.ClipTextEncoder` and
`models/pointbert.PointTransformer`, in the reference torch key layout.

The inverse of the JAX package's interop/torch_port `_lin/_attn/_trunk`:
flax Dense kernel [in, out] -> Linear weight [out, in]; per-head attention
q/k/v kernels [d, heads, head_dim] -> packed in_proj [3d, d]; out kernel
[heads, head_dim, d] -> out_proj [d, d]; LayerNorm scale -> weight.
Every converter is a pure rearrangement (transposes, reshapes, the q/k/v
concatenation), so it also maps the optimizer's moments, which have the
params' tree.

The file level: `read_jax_checkpoint` reads what the JAX package's
runtime/ckpt.save_checkpoint writes (a pickle of a flat {"a/b/c": ndarray}
dict: a TrainState's keys 0 step, 1/... variables, 2/... the optax chain's
state, or a bare variables tree's params/...), through an unpickler that
admits numpy arrays and nothing else; `state_dict_from_jax_checkpoint` and
`optimizer_state_from_jax_checkpoint` turn it into a G, R or FID-encoder
state_dict and the port Optimizer's AdamW and MultiStepLR state.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import pickle
from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..models.encoder import SegmentEncoder
from ..models.mdm_g import InteractionSegmentMDM
from ..models.refine_r import SegmentRefineNet


def _params(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if "params" in tree else tree


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(p: Mapping[str, Any], prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T), f"{prefix}.bias": _t(p["bias"])}


def _ln(p: Mapping[str, Any], prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _attn(p: Mapping[str, Any], prefix: str) -> dict[str, torch.Tensor]:
    d = np.asarray(p["query"]["kernel"]).shape[0]
    w = [np.asarray(p[n]["kernel"]).reshape(d, d).T for n in ("query", "key", "value")]
    b = [np.asarray(p[n]["bias"]).reshape(d) for n in ("query", "key", "value")]
    return {
        f"{prefix}.in_proj_weight": _t(np.concatenate(w, axis=0)),
        f"{prefix}.in_proj_bias": _t(np.concatenate(b, axis=0)),
        f"{prefix}.out_proj.weight": _t(np.asarray(p["out"]["kernel"]).reshape(d, d).T),
        f"{prefix}.out_proj.bias": _t(p["out"]["bias"]),
    }


def _trunk(p: Mapping[str, Any], prefix: str) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    n = sum(1 for k in p if k.startswith("layer_"))
    for i in range(n):
        lp, q = p[f"layer_{i}"], f"{prefix}.layers.{i}"
        sd.update(_attn(lp["self_attn"], f"{q}.self_attn"))
        sd.update(_lin(lp["linear1"], f"{q}.linear1"))
        sd.update(_lin(lp["linear2"], f"{q}.linear2"))
        sd.update(_ln(lp["norm1"], f"{q}.norm1"))
        sd.update(_ln(lp["norm2"], f"{q}.norm2"))
    return sd


def _cond_trunk(p: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    sd.update(_lin(p["hand_shape_process"]["shape_embed"], "hand_shape_process.shape_embed"))
    sd.update(_lin(p["obj_embed_process"]["embedding"], "obj_embed_process.embedding"))
    sd.update(_lin(p["input_process"]["poseEmbedding"], "input_process.poseEmbedding"))
    sd.update(_lin(p["obj_input_process"]["poseEmbedding"], "obj_input_process.poseEmbedding"))
    sd.update(_lin(p["input_merge"]["merge0"], "input_merge.0"))
    sd.update(_lin(p["input_merge"]["merge1"], "input_merge.2"))
    sd.update(_trunk(p["seqTransEncoder"], "seqTransEncoder"))
    return sd


def _common(p: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    sd = _cond_trunk(p)
    sd.update(_lin(p["output_process"]["poseFinal"], "output_process.poseFinal"))
    return sd


def g_state_dict_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX InteractionSegmentMDM params -> InteractionSegmentMDM state_dict."""
    p = _params(tree)
    sd = _common(p)
    sd.update(_lin(p["embed_timestep"]["time_embed_0"], "embed_timestep.time_embed.0"))
    sd.update(_lin(p["embed_timestep"]["time_embed_1"], "embed_timestep.time_embed.2"))
    sd.update(_lin(p["embed_text"], "embed_text"))
    return sd


def r_state_dict_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX SegmentRefineNet params -> SegmentRefineNet state_dict."""
    p = _params(tree)
    sd = _common(p)
    sd.update(_lin(p["h2o_dist_input_process"]["poseEmbedding"], "h2o_dist_input_process.poseEmbedding"))
    return sd


def _encoder_params(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    p = _params(tree)
    sd = _cond_trunk(p)
    for i, name in enumerate(("fc0", "fc1", "fc2")):
        sd.update(_lin(p["output_process"][name], f"output_process.poseFinal.{2 * i}"))
    return sd


def encoder_state_dict_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX SegmentEncoder variables (params and the `buffers` collection)
    -> SegmentEncoder state_dict: the MLP head's fc0/fc1/fc2 become
    output_process.poseFinal.0/.2/.4, the buffer classification_token."""
    sd = _encoder_params(tree)
    sd["classification_token"] = _t(tree["buffers"]["classification_token"])
    return sd


def clip_state_dict_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ClipTextEncoder params -> ClipTextEncoder state_dict (OpenAI names)."""
    p = _params(tree)
    sd = {
        "token_embedding.weight": _t(p["token_embedding"]["embedding"]),
        "positional_embedding": _t(p["positional_embedding"]),
        "text_projection": _t(p["text_projection"]),
    }
    sd.update(_ln(p["ln_final"], "ln_final"))
    n = sum(1 for k in p if k.startswith("resblock_"))
    for i in range(n):
        bp, q = p[f"resblock_{i}"], f"transformer.resblocks.{i}"
        sd.update(_ln(bp["ln_1"], f"{q}.ln_1"))
        sd.update(_ln(bp["ln_2"], f"{q}.ln_2"))
        sd.update(_attn(bp["attn"], f"{q}.attn"))
        sd.update(_lin(bp["mlp_fc"], f"{q}.mlp.c_fc"))
        sd.update(_lin(bp["mlp_proj"], f"{q}.mlp.c_proj"))
    return sd


def _conv(p: Mapping[str, Any], prefix: str) -> dict[str, torch.Tensor]:
    """A flax Dense over the channel axis -> a Conv1d(k=1) weight [out, in, 1]."""
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T[:, :, None]), f"{prefix}.bias": _t(p["bias"])}


def _bn(p: Mapping[str, Any], s: Mapping[str, Any], prefix: str) -> dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"]),
            f"{prefix}.running_mean": _t(s["mean"]), f"{prefix}.running_var": _t(s["var"]),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def pointbert_state_dict_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX PointTransformer variables ({params, batch_stats}) ->
    PointTransformer state_dict: the inverse of the JAX package's
    models/pointbert.convert_pointbert_state_dict (the tokenizer's Dense
    kernels become Conv1d weights, the other Dense kernels Linear weights,
    batch_stats the BatchNorm running mean and variance)."""
    p, s = tree["params"], tree["batch_stats"]["encoder"]
    e = p["encoder"]
    sd = {}
    sd.update(_conv(e["conv1a"], "encoder.first_conv.0"))
    sd.update(_bn(e["bn1"], s["bn1"], "encoder.first_conv.1"))
    sd.update(_conv(e["conv1b"], "encoder.first_conv.3"))
    sd.update(_conv(e["conv2a"], "encoder.second_conv.0"))
    sd.update(_bn(e["bn2"], s["bn2"], "encoder.second_conv.1"))
    sd.update(_conv(e["conv2b"], "encoder.second_conv.3"))
    sd.update(_lin(p["reduce_dim"], "reduce_dim"))
    sd["cls_token"] = _t(p["cls_token"])
    sd["cls_pos"] = _t(p["cls_pos"])
    sd.update(_lin(p["pos_fc1"], "pos_embed.0"))
    sd.update(_lin(p["pos_fc2"], "pos_embed.2"))
    sd.update(_ln(p["norm"], "norm"))
    n = sum(1 for k in p if k.startswith("block_"))
    for i in range(n):
        bp, q = p[f"block_{i}"], f"blocks.blocks.{i}"
        sd.update(_ln(bp["norm1"], f"{q}.norm1"))
        sd[f"{q}.attn.qkv.weight"] = _t(np.asarray(bp["qkv"]["kernel"]).T)
        sd.update(_lin(bp["proj"], f"{q}.attn.proj"))
        sd.update(_ln(bp["norm2"], f"{q}.norm2"))
        sd.update(_lin(bp["mlp_fc1"], f"{q}.mlp.fc1"))
        sd.update(_lin(bp["mlp_fc2"], f"{q}.mlp.fc2"))
    return sd


# ---------------------------------------------------------------------------
# The JAX package's checkpoint file (its runtime/ckpt.save_checkpoint)
# ---------------------------------------------------------------------------

# what pickled numpy arrays reference: ndarray reconstruction under protocol
# 5 (_frombuffer) and earlier ones (_reconstruct), and dtypes. numpy 2 keeps
# these modules in numpy._core, numpy 1 in numpy.core: a file names the one
# of the numpy that wrote it
_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"), ("numpy.core.numeric", "_frombuffer"),
    ("numpy.core.multiarray", "_reconstruct"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Resolves only the globals numpy arrays need; any other global (a
    callable a crafted pickle would run) raises before it is called."""

    def find_class(self, module: str, name: str):
        canonical = module.replace("numpy._core.", "numpy.core.", 1)
        if (canonical, name) not in _NUMPY_GLOBALS:
            raise pickle.UnpicklingError(
                f"refusing global {module}.{name}: a JAX package checkpoint holds numpy arrays only")
        if module == "numpy":
            return getattr(np, name)
        for where in (canonical.replace("numpy.core.", "numpy._core.", 1), canonical):
            try:
                return getattr(importlib.import_module(where), name)
            except (ImportError, AttributeError):
                continue
        raise pickle.UnpicklingError(f"{module}.{name}: not in numpy {np.__version__}")


@dataclasses.dataclass
class JaxCheckpoint:
    """A JAX package checkpoint: the variables tree ({"params": ...} and,
    for the encoder, {"buffers": ...}) and, from a train state, its step
    and the optax chain's AdamW moments (`mu`, `nu`: the variables' tree),
    adam count and schedule count. A bare variables pickle has no step and
    no optimizer (None)."""

    variables: dict
    step: Optional[int] = None
    mu: Optional[dict] = None
    nu: Optional[dict] = None
    adam_count: Optional[int] = None
    schedule_count: Optional[int] = None


def _unflatten(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        cur = out
        for p in parents:
            cur = cur.setdefault(p, {})
        cur[leaf] = v
    return out


def read_jax_checkpoint(path: str) -> JaxCheckpoint:
    """Read a `.ckpt` of the JAX package's pickle backend: a train state
    (save_train_state's model_XXXX.ckpt: keys 0, 1/..., 2/1/0/{count,mu,nu},
    2/1/2/count: the positions of make_optimizer's optax chain) or a bare
    variables tree (save_checkpoint(path, params): keys params/...). An
    orbax directory raises: reading it needs orbax and tensorstore."""
    if os.path.isdir(path) or str(path).rstrip("/").endswith(".orbax"):
        raise ValueError(
            f"{path}: an orbax checkpoint directory. The port reads only the JAX package's pickle "
            "backend: save_train_state(..., backend=\"pickle\"), the default, which writes model_XXXX.ckpt")
    with open(path, "rb") as f:
        try:
            flat = _NumpyOnlyUnpickler(f).load()
        except pickle.UnpicklingError as e:
            raise ValueError(f"{path}: {e}") from None
    if not isinstance(flat, dict) or not all(isinstance(k, str) for k in flat):
        raise ValueError(f"{path}: not a JAX package checkpoint (a pickled {{str: ndarray}} dict)")
    tree = _unflatten(flat)
    if "params" in tree:
        return JaxCheckpoint(variables=tree)
    if "0" not in tree or "1" not in tree:
        raise ValueError(f"{path}: neither a train state (keys 0, 1/..., 2/...) nor variables (params/...)")
    ck = JaxCheckpoint(variables=tree["1"], step=int(tree["0"]))
    if "2" in tree:
        chain = tree["2"].get("1", {})  # (per_param_clip: no state, adamw: (adam, decay, schedule))
        adam, sched = chain.get("0", {}), chain.get("2", {})
        if not {"count", "mu", "nu"} <= set(adam) or "count" not in sched:
            raise ValueError(f"{path}: the optimizer state is not in the layout of the JAX package's "
                             f"make_optimizer (2/1/0/{{count,mu,nu}}, 2/1/2/count); it has {sorted(flat)[:4]}...")
        ck.mu, ck.nu = adam["mu"], adam["nu"]
        ck.adam_count, ck.schedule_count = int(adam["count"]), int(sched["count"])
    return ck


# the module classes a JAX checkpoint can be loaded into: (variables ->
# state_dict, params only -> state_dict, which the moments go through: the
# encoder's moments also hold its buffers, which train nothing)
_CONVERTERS = (
    (InteractionSegmentMDM, g_state_dict_from_flax, g_state_dict_from_flax),
    (SegmentRefineNet, r_state_dict_from_flax, r_state_dict_from_flax),
    (SegmentEncoder, encoder_state_dict_from_flax, _encoder_params),
)


def _converters(module: torch.nn.Module):
    for cls, full, params_only in _CONVERTERS:
        if isinstance(module, cls):
            return full, params_only
    raise TypeError(f"no JAX checkpoint converter for {type(module).__name__}: one of "
                    f"{[c[0].__name__ for c in _CONVERTERS]}")


def state_dict_from_jax_checkpoint(module: torch.nn.Module, ck: JaxCheckpoint) -> dict[str, torch.Tensor]:
    """The checkpoint's variables as `module`'s state_dict (G, R or the FID
    encoder, by the module's class)."""
    return _converters(module)[0](ck.variables)


def optimizer_state_from_jax_checkpoint(model: torch.nn.Module, optimizer, ck: JaxCheckpoint) -> None:
    """Set `optimizer` (parallel/train.Optimizer over `model`'s parameters)
    to the checkpoint's: AdamW's exp_avg / exp_avg_sq are mu / nu through
    the params' converter, its step the adam count, at each trainable
    parameter's position in optimizer.params; the MultiStepLR's last_epoch
    is the schedule count and the learning rate base_lr * gamma ** (the
    number of milestones <= count), the optax schedule's value there. A
    parameter the moments lack starts with no AdamW state."""
    to_sd = _converters(model)[1]
    mu, nu = to_sd(ck.mu), to_sd(ck.nu)
    names = {id(p): n for n, p in model.named_parameters()}
    sd = optimizer.adamw.state_dict()
    sd["state"] = {}
    for i, p in enumerate(optimizer.params):
        n = names[id(p)]
        if n not in mu:
            continue
        if mu[n].shape != p.shape or nu[n].shape != p.shape:
            raise ValueError(f"{n}: moments of shape {tuple(mu[n].shape)} for a parameter of {tuple(p.shape)}")
        sd["state"][i] = {"step": torch.tensor(float(ck.adam_count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    sched = optimizer.scheduler
    count = int(ck.schedule_count)
    lrs = [b * sched.gamma ** sum(c for m, c in sched.milestones.items() if m <= count) for b in sched.base_lrs]
    for g, lr in zip(sd["param_groups"], lrs):
        g["lr"] = lr
    optimizer.adamw.load_state_dict(sd)
    sched.last_epoch = count
    sched._last_lr = [g["lr"] for g in optimizer.adamw.param_groups]
