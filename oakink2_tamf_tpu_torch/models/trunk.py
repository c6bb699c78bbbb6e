"""Shared transformer trunk and conditioning processors (port of
oakink2_tamf_tpu/models/trunk.py).

Parameter names follow the reference torch modules' state_dict layout
(`interop/torch_replica.TorchRefG/TorchRefR` in the JAX package): Linear
weights are [out, in], attention keeps torch's packed `in_proj_weight`
[3d, d]. Numerics follow the JAX package, which is the reference here:
post-LN layers, LayerNorm eps 1e-6 (flax's default), tanh "gelu" or erf
"gelu_exact", masked means over padded object slots.

Attention is plain PyTorch (the JAX package has no attention kernel either).
In train mode it drops the softmax weights with one keep mask of shape
[1, 1, L, L] per call, shared by the batch and the heads and scaled by
1/keep (flax's `broadcast_dropout`), drawn from torch's global generator
like every nn.Dropout of the port.

Compute dtype (`compute_dtype`, JAX models/trunk.py:67-140): the trunk
alone computes in bfloat16 when asked, by explicit casts where the JAX
package puts them. The trunk's input is cast to bf16 and its output back to
float32; each layer casts its attention input, the packed in-projection,
the out-projection and linear1/linear2 (weights and biases) to bf16, so
q @ k^T, the softmax, @ v and the activation run in bf16; LayerNorm takes a
float32 copy of its input and returns float32 (flax's LayerNorm with
float32 parameters), and norm1's output is cast back to bf16. So the first
layer's first residual add is in bf16 (its input was cast) and the later
layers' first residual add in float32 (norm2 returned float32), and every
second residual add is in bf16, as in JAX. The parameters stay float32.
Where the two frameworks still round differently: torch's bf16 softmax and
GELU compute in float32 inside the op and round once (XLA rounds between
the exp, the sum and the divide); torch's F.linear adds the bias before
its one rounding (flax rounds the product, then adds the bias in bf16);
and the dropout scale is bf16(1/keep) where flax divides by bf16(keep).

`remat` runs each layer under torch.utils.checkpoint (non-reentrant, RNG
state preserved, so the recomputed forward draws the same dropout masks)
when gradients are recorded, as JAX's nn.remat(EncoderLayer) does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6  # flax.linen.LayerNorm default
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a `model.compute_dtype` name; any other name raises."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}: one of {tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


@functools.lru_cache(maxsize=None)
def _check_bf16_device(device: torch.device) -> None:
    """bf16 tensor-core matmuls need compute capability 8.0 or later."""
    if device.type == "cuda" and torch.cuda.get_device_capability(device) < (8, 0):
        raise RuntimeError(f"{torch.cuda.get_device_name(device)} cannot run bfloat16 matmuls "
                           "(compute capability < 8.0): use model.compute_dtype float32")


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer` in x's dtype (flax Dense(dtype=...) promotes its parameters)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def sinusoidal_pe_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """The sin/cos table, [max_len, d], built in float32 numpy like the JAX package."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def activation_fn(name: str):
    if name == "gelu":
        return lambda a: F.gelu(a, approximate="tanh")
    if name == "gelu_exact":
        return F.gelu
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation {name!r}")


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch.nn.MultiheadAttention's parameter
    names (packed in_proj [3d, d], out_proj), in x's dtype. `mask` [.., L, L]
    bool, True = keep. In train mode the softmax weights are dropped with
    probability `dropout` (module note)."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        bs, L, d = x.shape
        h = self.num_heads
        q, k, v = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype)).chunk(3, dim=-1)
        q, k, v = (a.reshape(bs, L, h, d // h).transpose(1, 2) for a in (q, k, v))
        scale = float(torch.tensor(math.sqrt(d // h), dtype=x.dtype))  # sqrt(depth) in x's dtype, as flax
        logits = (q / scale) @ k.transpose(-1, -2)  # [bs, h, L, L]
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            kept = torch.empty((1, 1, L, L), device=x.device).bernoulli_(keep)
            weights = weights * (kept / keep).to(weights.dtype)
        out = weights @ v
        return _linear(self.out_proj, out.transpose(1, 2).reshape(bs, L, d))


class EncoderLayer(nn.Module):
    """Post-LN encoder layer: x = LN(x + Attn(x)); x = LN(x + W2 act(W1 x)),
    computing in `compute_dtype` (module note)."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int,
                 dropout: float = 0.1, activation: str = "gelu", compute_dtype: str = "float32"):
        super().__init__()
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.self_attn = SelfAttention(d_model, num_heads, dropout)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.act = activation_fn(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = self.norm1((x + self.dropout(self.self_attn(x.to(cd)))).float()).to(cd)
        h = _linear(self.linear2, self.dropout(self.act(_linear(self.linear1, x))))
        return self.norm2((x + self.dropout(h)).float())


class TransformerEncoder(nn.Module):
    """The layers in `compute_dtype` ("float32" or "bfloat16"), each under
    activation checkpointing with `remat` when gradients are recorded. The
    output has the input's dtype."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int, num_layers: int,
                 dropout: float = 0.1, activation: str = "gelu", *, remat: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.remat = remat
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, num_heads, ff_size, dropout, activation, compute_dtype)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        if self.compute_dtype == torch.bfloat16:
            _check_bf16_device(x.device)
        x = x.to(self.compute_dtype)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, use_reentrant=False, preserve_rng_state=True)
            else:
                x = layer(x)
        return x.to(in_dtype)


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table over the whole (cond + motion) sequence."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 5000):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_pe_table(d_model, max_len)), persistent=False
        )
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.pe[None, : x.shape[1]])


class TimestepEmbedder(nn.Module):
    """MLP over the sinusoidal PE row of each timestep: [bs] int -> [bs, d]."""

    def __init__(self, latent_dim: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_pe_table(latent_dim, max_len)), persistent=False
        )
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(), nn.Linear(latent_dim, latent_dim)
        )

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(self.pe[timesteps])


class InputProcess(nn.Module):
    """Per-frame stream embed: [bs, L, C] -> [bs, L, d]."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(in_dim, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.poseEmbedding(x)


def _masked_mean_objects(h: torch.Tensor, obj_mask: torch.Tensor) -> torch.Tensor:
    """Mean over the object axis (dim 1) counting only real objects."""
    m = obj_mask.to(h.dtype).reshape(obj_mask.shape + (1,) * (h.ndim - 2))
    return torch.sum(h * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1), 1.0)


class ObjectInputProcess(nn.Module):
    """[bs, nobj, L, 9] (+ mask [bs, nobj]) -> per-object embed, masked mean -> [bs, L, d]."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(in_dim, latent_dim)

    def forward(self, obj_traj: torch.Tensor, obj_mask: torch.Tensor) -> torch.Tensor:
        return _masked_mean_objects(self.poseEmbedding(obj_traj), obj_mask)


class ObjectEmbedProcess(nn.Module):
    """[bs, nobj, 768] (+ mask) -> masked mean over objects, then linear -> [bs, d]."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.embedding = nn.Linear(in_dim, latent_dim)

    def forward(self, obj_embedding: torch.Tensor, obj_mask: torch.Tensor) -> torch.Tensor:
        return self.embedding(_masked_mean_objects(obj_embedding, obj_mask))


class HandShapeProcess(nn.Module):
    """MANO betas [bs, L, 10] -> mean over L -> linear -> [bs, d]."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.shape_embed = nn.Linear(in_dim, latent_dim)

    def forward(self, shape: torch.Tensor) -> torch.Tensor:
        return self.shape_embed(shape.mean(dim=1))


def hand_side_embed(hand_side: torch.Tensor, latent_dim: int) -> torch.Tensor:
    """Fixed (untrained) hand-side token: rh = zeros, lh = e_0. [bs] -> [bs, d]."""
    out = torch.zeros(hand_side.shape + (latent_dim,), device=hand_side.device)
    out[:, 0] = hand_side.to(torch.float32)
    return out


class OutputProcess(nn.Module):
    def __init__(self, latent_dim: int, out_dim: int):
        super().__init__()
        self.poseFinal = nn.Linear(latent_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.poseFinal(x)


def input_merge(n_streams: int, latent_dim: int) -> nn.Sequential:
    """Fuse streams: concat -> Linear -> SiLU -> Linear (keys input_merge.0/.2)."""
    return nn.Sequential(
        nn.Linear(n_streams * latent_dim, latent_dim), nn.SiLU(), nn.Linear(latent_dim, latent_dim)
    )
