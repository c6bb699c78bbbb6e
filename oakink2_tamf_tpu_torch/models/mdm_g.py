"""MF-MDM G, the conditional motion-diffusion denoiser (port of
oakink2_tamf_tpu/models/mdm_g.py).

Tokens: [timestep, text, hand_side, hand_shape, obj_embed] + L motion frames,
sinusoidal PE over the whole sequence, post-LN encoder, output head on the
trailing L positions. The frozen CLIP text features enter as `text_emb`.

Train mode (`model.train()`) applies dropout (nn.Dropout, torch's global
generator) and the classifier-free text-masking hook `cond_mask_prob`, which
is 0 in every TaMF config.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn as nn

from .trunk import (
    HandShapeProcess,
    InputProcess,
    ObjectEmbedProcess,
    ObjectInputProcess,
    OutputProcess,
    PositionalEncoding,
    TimestepEmbedder,
    TransformerEncoder,
    hand_side_embed,
    input_merge,
)


@dataclasses.dataclass(frozen=True)
class MDMConfig:
    input_dim: int = 99
    obj_input_dim: int = 9
    hand_shape_dim: int = 10
    obj_embed_dim: int = 768
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"
    clip_dim: int = 512
    cond_mask_prob: float = 0.0
    remat: bool = False  # checkpoint each trunk layer (memory for FLOPs)
    compute_dtype: str = "float32"  # "bfloat16": the trunk computes in bf16 (models/trunk.py)

    @classmethod
    def arch_mdm(cls) -> "MDMConfig":
        return cls(latent_dim=256, ff_size=1024)

    @classmethod
    def arch_mdm_l(cls) -> "MDMConfig":
        return cls(latent_dim=512, ff_size=2048)


NUM_COND_TOKENS_G = 5


class InteractionSegmentMDM(nn.Module):
    def __init__(self, cfg: MDMConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.embed_timestep = TimestepEmbedder(d)
        self.embed_text = nn.Linear(cfg.clip_dim, d)
        self.hand_shape_process = HandShapeProcess(cfg.hand_shape_dim, d)
        self.obj_embed_process = ObjectEmbedProcess(cfg.obj_embed_dim, d)
        self.input_process = InputProcess(cfg.input_dim, d)
        self.obj_input_process = ObjectInputProcess(cfg.obj_input_dim, d)
        self.input_merge = input_merge(2, d)
        self.sequence_pos_encoder = PositionalEncoding(d, cfg.dropout)
        self.seqTransEncoder = TransformerEncoder(
            d, cfg.num_heads, cfg.ff_size, cfg.num_layers, cfg.dropout, cfg.activation,
            remat=cfg.remat, compute_dtype=cfg.compute_dtype,
        )
        self.output_process = OutputProcess(d, cfg.input_dim)

    def _mask_cond(self, cond_vec: torch.Tensor, force_mask: bool) -> torch.Tensor:
        """Classifier-free conditioning mask (mdm.py:99-109): zero the text
        features when forced, or per sample with cond_mask_prob in train mode."""
        if force_mask:
            return torch.zeros_like(cond_vec)
        p = self.cfg.cond_mask_prob
        if self.training and p > 0.0:
            keep = torch.bernoulli(torch.full((cond_vec.shape[0], 1), 1.0 - p, device=cond_vec.device))
            return cond_vec * keep.to(cond_vec.dtype)
        return cond_vec

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cond: dict[str, Any],
                force_mask: bool = False) -> torch.Tensor:
        """x [bs, L, 99] noisy pose_repr, timesteps [bs] int -> [bs, L, 99]."""
        d = self.cfg.latent_dim
        text = self._mask_cond(cond["text_emb"].to(torch.float32), force_mask)
        emb = torch.stack(
            [
                self.embed_timestep(timesteps),
                self.embed_text(text),
                hand_side_embed(cond["hand_side"], d),
                self.hand_shape_process(cond["shape"]),
                self.obj_embed_process(cond["obj_embedding"], cond["obj_mask"]),
            ],
            dim=1,
        )
        emb = torch.nan_to_num(emb)
        merged = self.input_merge(
            torch.cat(
                [
                    self.input_process(x),
                    self.obj_input_process(cond["obj_traj"], cond["obj_mask"]),
                ],
                dim=-1,
            )
        )
        merged = torch.nan_to_num(merged)
        xseq = self.sequence_pos_encoder(torch.cat([emb, merged], dim=1))
        out = self.seqTransEncoder(xseq)[:, NUM_COND_TOKENS_G:]
        return torch.nan_to_num(self.output_process(out))
