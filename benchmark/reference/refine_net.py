"""MF-MDM R's network in plain float32 PyTorch for the benchmark's reference
(upstream model/segment_refine_model.py; parameter names as the program's):
condition tokens [hand_side, hand_shape, obj_embed], the merged pose,
object and h2o-distance streams, the post-LN trunk, and a residual output.
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
    TransformerEncoder,
    hand_side_embed,
    input_merge,
)


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    input_dim: int = 99
    obj_input_dim: int = 9
    hand_shape_dim: int = 10
    obj_embed_dim: int = 768
    latent_dim: int = 256
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu_exact"
    n_hand_verts: int = 778


NUM_COND_TOKENS_R = 3
PAD_OBJECT_H2O = 10.0  # finite h2o of a padded object slot (far from everything)


class SegmentRefineNet(nn.Module):
    def __init__(self, cfg: RefineConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        self.hand_shape_process = HandShapeProcess(cfg.hand_shape_dim, d)
        self.obj_embed_process = ObjectEmbedProcess(cfg.obj_embed_dim, d)
        self.input_process = InputProcess(cfg.input_dim, d)
        self.obj_input_process = ObjectInputProcess(cfg.obj_input_dim, d)
        self.h2o_dist_input_process = InputProcess(cfg.n_hand_verts, d)
        self.input_merge = input_merge(3, d)
        self.sequence_pos_encoder = PositionalEncoding(d, cfg.dropout)
        self.seqTransEncoder = TransformerEncoder(
            d, cfg.num_heads, cfg.ff_size, cfg.num_layers, cfg.dropout, cfg.activation
        )
        self.output_process = OutputProcess(d, cfg.input_dim)

    def forward(self, x_in: torch.Tensor, h2o_dist: torch.Tensor, cond: dict[str, Any]) -> torch.Tensor:
        """x_in [bs, L, 99], h2o_dist [bs, L, 778] -> refined pose_repr [bs, L, 99]."""
        d = self.cfg.latent_dim
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
                [
                    self.input_process(x_in),
                    self.obj_input_process(cond["obj_traj"], cond["obj_mask"]),
                    self.h2o_dist_input_process(h2o_dist),
                ],
                dim=-1,
            )
        )
        merged = torch.nan_to_num(merged)
        xseq = self.sequence_pos_encoder(torch.cat([emb, merged], dim=1))
        out = self.seqTransEncoder(xseq)[:, NUM_COND_TOKENS_R:]
        return torch.nan_to_num(x_in + self.output_process(out))  # residual
