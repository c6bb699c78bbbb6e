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
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


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


def encoder_state_dict_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX SegmentEncoder variables (params and the `buffers` collection)
    -> SegmentEncoder state_dict: the MLP head's fc0/fc1/fc2 become
    output_process.poseFinal.0/.2/.4, the buffer classification_token."""
    p = _params(tree)
    sd = _cond_trunk(p)
    for i, name in enumerate(("fc0", "fc1", "fc2")):
        sd.update(_lin(p["output_process"][name], f"output_process.poseFinal.{2 * i}"))
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
