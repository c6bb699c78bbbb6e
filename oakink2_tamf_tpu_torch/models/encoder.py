"""SegmentEncoder, the action-classification transformer behind FID (port of
oakink2_tamf_tpu/models/encoder.py; the reference's model/segment_encoder.py).

The trunk of G and R: 3 cond tokens [hand_side, shape, obj_embed], the L
motion frames (pose + object trajectory through a 2-stream input merge) and
a trailing classification token. The token is a zero buffer, as the
reference's register_buffer: it is in the state_dict but not in
parameters(), so no optimizer moves it. The cls position's latent is the
FID `encoding`; a 3-layer SiLU MLP over it gives the action logits
(`activation`). State_dict keys are the reference's, so its trained
checkpoint (encoder__fid_1/save/model_0399.pt) loads directly.
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
    PositionalEncoding,
    TransformerEncoder,
    hand_side_embed,
    input_merge,
)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """config/arch_encoder.yml: latent 64, ff 128, 2 layers."""

    output_dim: int = 70
    input_dim: int = 99
    obj_input_dim: int = 9
    hand_shape_dim: int = 10
    obj_embed_dim: int = 768
    latent_dim: int = 64
    ff_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"


NUM_COND_TOKENS_E = 3
COND_KEYS = ("hand_side", "shape", "obj_embedding", "obj_traj", "obj_mask")


class _OutputProcess(nn.Module):
    """The 3-layer SiLU MLP head: Linear -> SiLU -> Linear -> SiLU -> Linear
    (keys poseFinal.0/.2/.4)."""

    def __init__(self, latent_dim: int, out_dim: int):
        super().__init__()
        self.poseFinal = nn.Sequential(
            nn.Linear(latent_dim, latent_dim), nn.SiLU(),
            nn.Linear(latent_dim, latent_dim), nn.SiLU(),
            nn.Linear(latent_dim, out_dim),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.poseFinal(x)


class SegmentEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.hand_shape_process = HandShapeProcess(cfg.hand_shape_dim, d)
        self.obj_embed_process = ObjectEmbedProcess(cfg.obj_embed_dim, d)
        self.input_process = InputProcess(cfg.input_dim, d)
        self.obj_input_process = ObjectInputProcess(cfg.obj_input_dim, d)
        self.input_merge = input_merge(2, d)
        self.register_buffer("classification_token", torch.zeros(1, 1, d))
        self.sequence_pos_encoder = PositionalEncoding(d, cfg.dropout)
        self.seqTransEncoder = TransformerEncoder(
            d, cfg.num_heads, cfg.ff_size, cfg.num_layers, cfg.dropout, cfg.activation
        )
        self.output_process = _OutputProcess(d, cfg.output_dim)

    def forward(self, pose_repr: torch.Tensor, cond: dict[str, Any]) -> dict[str, torch.Tensor]:
        """pose_repr [bs, L, 99] -> {"encoding" [bs, d], "activation" [bs, output_dim]}."""
        d = self.cfg.latent_dim
        bs = pose_repr.shape[0]
        emb = torch.stack(
            [
                hand_side_embed(cond["hand_side"], d),
                self.hand_shape_process(cond["shape"]),
                self.obj_embed_process(cond["obj_embedding"], cond["obj_mask"]),
            ],
            dim=1,
        )
        emb = torch.nan_to_num(emb)
        merged = self.input_merge(
            torch.cat(
                [self.input_process(pose_repr), self.obj_input_process(cond["obj_traj"], cond["obj_mask"])],
                dim=-1,
            )
        )
        merged = torch.nan_to_num(merged)
        cls = self.classification_token.expand(bs, 1, d)
        xseq = self.sequence_pos_encoder(torch.cat([emb, merged, cls], dim=1))  # [bs, 3+L+1, d]
        encoding = self.seqTransEncoder(xseq)[:, -1]
        return {"encoding": encoding, "activation": self.output_process(encoding)}
