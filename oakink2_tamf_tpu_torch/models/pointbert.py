"""PointBERT object encoder (port of oakink2_tamf_tpu/models/pointbert.py; the
reference's model/pointbert/{point_encoder,dvae,misc}.py).

The network that turns an object cloud (8192 points) into the 768-d
`obj_embedding` conditioning vector: farthest-point sampling of 512
centres, their 32 nearest points as centre-relative groups, a two-stage
shared MLP + maxpool tokenizer (`MiniPointNet`, dvae.Encoder), and a
12-block pre-LN ViT of width 384 that re-injects the positional embedding
before every block, ending in [cls | max over tokens].

Module names and state_dict keys are the reference's (encoder.first_conv.*,
reduce_dim, cls_token, cls_pos, pos_embed.*, blocks.blocks.N.*, norm), so
its pretrained checkpoint loads as it is (`load_pointbert_checkpoint`). The
1x1 convolutions stay Conv1d with their [out, in, 1] weights. BatchNorm
uses the running statistics in eval() and the batch's in train(), as the
JAX package's train=False / train=True.

`farthest_point_sampling` runs its n_samples steps as a loop of tensor ops
on the cloud's device, batched over clouds, with no host sync; each step's
distance is the sum of the three squared coordinate differences in that
order, so CPU and GPU pick the same points. `knn_group` takes the direct
squared difference, never the |a|^2 + |b|^2 - 2ab expansion, which moves
near-ties. Nothing here is a kernel of the JAX package (it has no Pallas
counterpart); the embedding runs offline (launch/compute_obj_assets.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Grouping ops
# ---------------------------------------------------------------------------


def _sq_dist(pts: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """(pts - ctr)^2 summed over x, y, z in that order; broadcasts."""
    d = pts[..., 0] - ctr[..., 0]
    out = d * d
    d = pts[..., 1] - ctr[..., 1]
    out = out + d * d
    d = pts[..., 2] - ctr[..., 2]
    return out + d * d


def farthest_point_sampling(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """FPS indices [B, n_samples] (int64) over xyz [B, N, 3]: deterministic,
    starting at point 0, min-distance initialised to inf, the next point
    the first maximum of the running min-distance (argmax's first index,
    as jnp.argmax)."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)
    idx = torch.empty((B, n_samples), dtype=torch.int64, device=xyz.device)
    min_d = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    last = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    for i in range(n_samples):
        idx[:, i] = last
        min_d = torch.minimum(min_d, _sq_dist(xyz, xyz[rows, last][:, None, :]))
        last = torch.argmax(min_d, dim=1)
    return idx


def knn_group(xyz: torch.Tensor, centers: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """For each centre its k nearest points, centre-relative.
    xyz [B, N, 3], centers [B, G, 3] -> (neigh [B, G, k, 3], idx [B, G, k]).
    The k are in ascending distance; the tokenizer is invariant to their
    order, so only the set matters."""
    d = _sq_dist(xyz[:, None, :, :], centers[:, :, None, :])  # [B, G, N]
    _, idx = torch.topk(d, k, dim=-1, largest=False)
    B, G, _ = idx.shape
    neigh = torch.gather(xyz, 1, idx.reshape(B, G * k, 1).expand(-1, -1, 3)).reshape(B, G, k, 3)
    return neigh - centers[:, :, None, :], idx


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class MiniPointNet(nn.Module):
    """dvae.Encoder: shared MLP -> maxpool -> [global | local] -> shared MLP
    -> maxpool, as 1x1 convolutions on [B*G, C, K]."""

    def __init__(self, encoder_channel: int = 256):
        super().__init__()
        self.encoder_channel = encoder_channel
        self.first_conv = nn.Sequential(
            nn.Conv1d(3, 128, 1), nn.BatchNorm1d(128, eps=1e-5), nn.ReLU(inplace=True), nn.Conv1d(128, 256, 1))
        self.second_conv = nn.Sequential(
            nn.Conv1d(512, 512, 1), nn.BatchNorm1d(512, eps=1e-5), nn.ReLU(inplace=True),
            nn.Conv1d(512, encoder_channel, 1))

    def forward(self, groups: torch.Tensor) -> torch.Tensor:
        """groups [B, G, K, 3] -> tokens [B, G, encoder_channel]."""
        B, G, K, _ = groups.shape
        x = self.first_conv(groups.reshape(B * G, K, 3).transpose(1, 2))  # [BG, 256, K]
        g = torch.amax(x, dim=2, keepdim=True)
        x = self.second_conv(torch.cat([g.expand(-1, -1, K), x], dim=1))  # [BG, C, K]
        return torch.amax(x, dim=2).reshape(B, G, self.encoder_channel)


class Attention(nn.Module):
    """The reference's attention: a fused qkv projection without bias whose
    output factors as (3, heads, head_dim), and an out projection with bias."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads).permute(2, 0, 3, 1, 4)
        h = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])  # [B, H, N, hd]
        return self.proj(h.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def drop_path(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """Per-sample stochastic depth: each row kept with 1 - rate, scaled by
    1 / (1 - rate); the identity in eval or at rate 0."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.bernoulli(torch.full((x.shape[0],) + (1,) * (x.ndim - 1), keep, device=x.device, dtype=x.dtype))
    return x * mask / keep


class Block(nn.Module):
    """Pre-LN ViT block (point_encoder.py:32-78): LayerNorm eps 1e-5, exact
    GELU, drop path on both residual branches in train mode."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path_rate, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate, self.training)


class TransformerEncoder(nn.Module):
    """The reference's block stack (keys blocks.blocks.N.*): the positional
    embedding is added to the input of every block."""

    def __init__(self, dim: int, num_heads: int, drop_path_rates):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, num_heads, drop_path_rate=float(r)) for r in drop_path_rates)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x + pos)
        return x


@dataclasses.dataclass(frozen=True)
class PointBertConfig:
    """PointTransformer_8192point_2layer.yaml values."""

    trans_dim: int = 384
    depth: int = 12
    drop_path_rate: float = 0.1
    num_heads: int = 6
    group_size: int = 32
    num_group: int = 512
    encoder_dims: int = 256


class PointTransformer(nn.Module):
    def __init__(self, cfg: PointBertConfig = PointBertConfig()):
        super().__init__()
        self.cfg = cfg
        C = cfg.trans_dim
        self.encoder = MiniPointNet(cfg.encoder_dims)
        self.reduce_dim = nn.Linear(cfg.encoder_dims, C)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.cls_pos = nn.Parameter(torch.randn(1, 1, C))
        self.pos_embed = nn.Sequential(nn.Linear(3, 128), nn.GELU(), nn.Linear(128, C))
        self.blocks = TransformerEncoder(C, cfg.num_heads, np.linspace(0.0, cfg.drop_path_rate, cfg.depth))
        self.norm = nn.LayerNorm(C, eps=1e-5)
        self.apply(self._init_weights)

    @staticmethod
    def _init_weights(m: nn.Module) -> None:
        """The reference's init (point_encoder.py _init_weights)."""
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            nn.init.trunc_normal_(m.weight, std=0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)

    def group(self, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """pts [B, N, 3] -> (centre-relative groups [B, G, K, 3], centres [B, G, 3])."""
        fps_idx = farthest_point_sampling(pts, self.cfg.num_group)
        centers = torch.gather(pts, 1, fps_idx[..., None].expand(-1, -1, 3))
        neigh, _ = knn_group(pts, centers, self.cfg.group_size)
        return neigh, centers

    def tokenize(self, neigh: torch.Tensor) -> torch.Tensor:
        """Centre-relative groups [B, G, K, 3] -> tokens [B, G, trans_dim]."""
        return self.reduce_dim(self.encoder(neigh))

    def transform(self, tokens: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
        """Tokens and their centres -> [B, 2*trans_dim]: the cls token in
        front, the blocks, the final norm, [cls | max over tokens]."""
        B, C = tokens.shape[0], self.cfg.trans_dim
        x = torch.cat([self.cls_token.expand(B, 1, C), tokens], dim=1)
        pos = torch.cat([self.cls_pos.expand(B, 1, C), self.pos_embed(centers)], dim=1)
        x = self.norm(self.blocks(x, pos))
        return torch.cat([x[:, 0], torch.amax(x[:, 1:], dim=1)], dim=-1)

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        """pts [B, N, 3] -> object embedding [B, 2*trans_dim] (768)."""
        neigh, centers = self.group(pts)
        return self.transform(self.tokenize(neigh), centers)


@torch.no_grad()
def compute_object_embedding(model: PointTransformer, pts: np.ndarray) -> np.ndarray:
    """One object cloud [N, 3] -> its embedding [2*trans_dim] (float32 numpy),
    computed in eval mode on the module's device."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        x = torch.as_tensor(np.asarray(pts, np.float32), device=dev)[None]
        return model(x)[0].cpu().numpy()
    finally:
        model.train(was_training)


# ---------------------------------------------------------------------------
# The reference's pretrained checkpoint
# ---------------------------------------------------------------------------

PREFIXES = ("module.point_encoder.", "point_encoder.")


def load_pointbert_checkpoint(pt_path: str, model: PointTransformer | None = None,
                              cfg: PointBertConfig = PointBertConfig()) -> PointTransformer:
    """Load the reference's Point-BERT torch checkpoint (ckpt['state_dict']
    or a bare state_dict, keys under `module.point_encoder.` or
    `point_encoder.`) into `model` (a new PointTransformer(cfg) on the CPU
    when None) and return it. Non-tensor entries and keys the model does
    not have are skipped; a key the model needs but the file lacks raises
    (BatchNorm's num_batches_tracked excepted)."""
    ckpt = torch.load(pt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt.state_dict()
    found: dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        for p in PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
                break
        if isinstance(v, torch.Tensor):
            found[k] = v
    model = model if model is not None else PointTransformer(cfg)
    own = model.state_dict()
    missing = sorted(k for k in set(own) - set(found) if not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"{pt_path} lacks {len(missing)} Point-BERT keys, e.g. {missing[:3]}")
    model.load_state_dict({k: found[k] for k in own if k in found}, strict=False)
    return model
