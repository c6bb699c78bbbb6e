"""The transformer trunk and conditioning processors of G and R in plain
float32 PyTorch, for the benchmark's reference, which imports nothing of
the port.

The network is TaMF's (upstream model/interaction_segment_mdm.py: a
post-LN torch nn.TransformerEncoder over condition tokens and motion
frames). The parameter names are nn.TransformerEncoderLayer's (packed
`in_proj_weight` [3d, d], `out_proj`, `linear1`, `linear2`, `norm1`,
`norm2`), which the program's modules also use, so the benchmark writes
the same weights into both by name. Where the program's numerics are its
own choice, the reference follows them, since it judges the program's
outputs: LayerNorm eps 1e-6 (upstream torch has 1e-5), and in train mode
one attention keep mask of shape [1, 1, L, L] per call, shared by the batch
and the heads, scaled by 1/keep, drawn from torch's global generator in the
program's order (positional dropout, then per layer the attention mask,
the attention output's dropout, the feed-forward's two dropouts).

Activations by the configuration's name: "gelu_exact" is the erf GELU
(upstream torch's "gelu"), "gelu" the tanh form, as the program names them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6
ACTIVATIONS = {"gelu_exact": F.gelu, "gelu": lambda a: F.gelu(a, approximate="tanh"), "relu": F.relu}


def sinusoidal_pe_table(d_model: int, max_len: int = 5000) -> torch.Tensor:
    """The sin/cos table [max_len, d], in float32."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


class SelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dropout: float):
        super().__init__()
        self.num_heads, self.dropout = num_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs, L, d = x.shape
        h = self.num_heads
        q, k, v = (t.reshape(bs, L, h, d // h).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        weights = torch.softmax((q / math.sqrt(d // h)) @ k.transpose(-1, -2), dim=-1)
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            weights = weights * (torch.empty((1, 1, L, L), device=x.device).bernoulli_(keep) / keep)
        return self.out_proj((weights @ v).transpose(1, 2).reshape(bs, L, d))


class EncoderLayer(nn.Module):
    """Post-LN: x = LN(x + drop(Attn(x))); x = LN(x + drop(W2 drop(act(W1 x))))."""

    def __init__(self, d_model: int, num_heads: int, ff_size: int, dropout: float, activation: str):
        super().__init__()
        self.self_attn = SelfAttention(d_model, num_heads, dropout)
        self.linear1 = nn.Linear(d_model, ff_size)
        self.linear2 = nn.Linear(ff_size, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.act = ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout(self.self_attn(x)))
        return self.norm2(x + self.dropout(self.linear2(self.dropout(self.act(self.linear1(x))))))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ff_size: int, num_layers: int, dropout: float,
                 activation: str):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d_model, num_heads, ff_size, dropout, activation)
                                    for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table over the whole (condition + motion) sequence."""

    def __init__(self, d_model: int, dropout: float):
        super().__init__()
        self.register_buffer("pe", sinusoidal_pe_table(d_model), persistent=False)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(x + self.pe[None, : x.shape[1]])


class TimestepEmbedder(nn.Module):
    """MLP over the sinusoidal row of each timestep: [bs] int -> [bs, d]."""

    def __init__(self, latent_dim: int):
        super().__init__()
        self.register_buffer("pe", sinusoidal_pe_table(latent_dim), persistent=False)
        self.time_embed = nn.Sequential(nn.Linear(latent_dim, latent_dim), nn.SiLU(),
                                        nn.Linear(latent_dim, latent_dim))

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        return self.time_embed(self.pe[timesteps])


class InputProcess(nn.Module):
    """Per-frame embedding: [bs, L, C] -> [bs, L, d]."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(in_dim, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.poseEmbedding(x)


def _masked_mean_objects(h: torch.Tensor, obj_mask: torch.Tensor) -> torch.Tensor:
    """Mean over the object axis (dim 1) of the real objects."""
    m = obj_mask.to(h.dtype).reshape(obj_mask.shape + (1,) * (h.ndim - 2))
    return (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


class ObjectInputProcess(nn.Module):
    """[bs, nobj, L, 9] -> per-object embedding, mean over real objects -> [bs, L, d]."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.poseEmbedding = nn.Linear(in_dim, latent_dim)

    def forward(self, obj_traj: torch.Tensor, obj_mask: torch.Tensor) -> torch.Tensor:
        return _masked_mean_objects(self.poseEmbedding(obj_traj), obj_mask)


class ObjectEmbedProcess(nn.Module):
    """[bs, nobj, 768] -> mean over real objects, then linear -> [bs, d]."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.embedding = nn.Linear(in_dim, latent_dim)

    def forward(self, obj_embedding: torch.Tensor, obj_mask: torch.Tensor) -> torch.Tensor:
        return self.embedding(_masked_mean_objects(obj_embedding, obj_mask))


class HandShapeProcess(nn.Module):
    """MANO betas [bs, L, 10] -> mean over the frames -> linear -> [bs, d]."""

    def __init__(self, in_dim: int, latent_dim: int):
        super().__init__()
        self.shape_embed = nn.Linear(in_dim, latent_dim)

    def forward(self, shape: torch.Tensor) -> torch.Tensor:
        return self.shape_embed(shape.mean(dim=1))


def hand_side_embed(hand_side: torch.Tensor, latent_dim: int) -> torch.Tensor:
    """The fixed hand-side token: rh zeros, lh e_0. [bs] -> [bs, d]."""
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
    """concat -> Linear -> SiLU -> Linear (keys input_merge.0 / .2)."""
    return nn.Sequential(nn.Linear(n_streams * latent_dim, latent_dim), nn.SiLU(),
                         nn.Linear(latent_dim, latent_dim))
