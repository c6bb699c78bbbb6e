"""TamfPipeline: the G -> R serving path on one GPU (port of
oakink2_tamf_tpu/serving.py, DDPM sampler).

    pipe = TamfPipeline.load(g_ckpt, r_ckpt, mano_path=..., clip_ckpt=...)
    results = pipe.generate(segments)   # one dict of numpy arrays per segment

Requests pad up to `batch_size` (the last segment repeats), CLIP text
features are cached per prompt, G's chain runs on the device, G's output is
zeroed past each segment's true length before R (R only ever sees
zero-padded samples in the reference), and R runs with the batch mask as
its frame mask. Checkpoints are torch state_dicts in the reference key
layout. The whole call runs under torch.inference_mode().
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .core import diffusion as D
from .core import mano as M
from .data.collate import SegmentCollate
from .models.clip_text import FrozenClipText
from .models.mdm_g import InteractionSegmentMDM, MDMConfig
from .models.refine_r import RefineConfig, SegmentRefineNet, refine_forward, stack_mano_models

BATCH_KEYS = (
    "pose_repr", "mask", "shape", "hand_side",
    "obj_traj", "obj_embedding", "obj_mask", "obj_points",
)


def load_state_dict_file(module: torch.nn.Module, path: str) -> None:
    """Load a reference-layout torch state_dict file into `module`; keys the
    module does not have (e.g. the reference's clip_model.*) are ignored, a
    key the module needs but the file lacks raises."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(sd, dict):
        sd = sd.state_dict()
    own = module.state_dict()
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} keys, e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k] for k in own})


@dataclasses.dataclass
class TamfPipeline:
    g_model: InteractionSegmentMDM
    refine_net: SegmentRefineNet
    sched: D.DiffusionSchedule
    mano_stack: M.ManoTensors
    clip: FrozenClipText
    device: torch.device
    batch_size: int = 16
    seq_len: int = 160
    max_nobj: int = 4
    n_obj_points: int = 2048

    def __post_init__(self):
        self._collate = SegmentCollate(max_nobj=self.max_nobj, n_obj_points=self.n_obj_points)

    @classmethod
    def load(
        cls,
        g_ckpt: Optional[str] = None,
        r_ckpt: Optional[str] = None,
        *,
        g_config: MDMConfig = MDMConfig.arch_mdm_l(),
        r_config: RefineConfig = RefineConfig(),
        mano_path: Optional[str] = None,
        clip_ckpt: Optional[str] = None,
        bpe_path: Optional[str] = None,
        diffusion_steps: int = 1000,
        timestep_respacing: str = "",
        device: str | torch.device = "cuda",
        seed: int = 0,
        **kwargs,
    ) -> "TamfPipeline":
        """Build the pipeline on `device` ("cuda" unless told "cpu"). Without
        checkpoints the nets are randomly initialised from `seed`."""
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            g_model = InteractionSegmentMDM(g_config)
            torch.manual_seed(seed + 1)
            refine_net = SegmentRefineNet(r_config)
        if g_ckpt:
            load_state_dict_file(g_model, g_ckpt)
        if r_ckpt:
            load_state_dict_file(refine_net, r_ckpt)
        for m in (g_model, refine_net):
            m.to(dev).eval().requires_grad_(False)
        return cls(
            g_model=g_model,
            refine_net=refine_net,
            sched=D.tamf_schedule(diffusion_steps, "cosine", timestep_respacing).to(dev),
            mano_stack=stack_mano_models(
                M.get_mano_model(mano_path, "right"), M.get_mano_model(mano_path, "left"), dev
            ),
            clip=FrozenClipText(checkpoint_path=clip_ckpt, bpe_path=bpe_path, seed=seed, device=dev),
            device=dev,
            **kwargs,
        )

    def _run(self, batch: dict[str, torch.Tensor], generator, noise, step_noise):
        cond = {k: batch[k] for k in ("text_emb", "hand_side", "shape", "obj_traj", "obj_embedding", "obj_mask")}
        bs, L = batch["pose_repr"].shape[:2]
        sample = D.p_sample_loop(
            lambda x, t: self.g_model(x, t, cond), self.sched, (bs, L, 99),
            device=self.device, generator=generator, noise=noise, step_noise=step_noise,
        )
        b2 = dict(batch)
        # R sees G's sample zero-padded past each true length, as the JAX
        # package's serving does (oakink2_tamf_tpu/serving.py:87); the original
        # TaMF chain feeds R the raw padded sample instead
        b2["sample_pose_repr"] = sample * batch["mask"][:, :, None]
        out = refine_forward(self.refine_net, self.mano_stack, b2, with_target=False,
                             loss_frame_mask=batch["mask"])
        return {
            "refine_pose_repr": out["refine_pose_repr"],
            "refine_hand_verts": out["refine_hand_verts"],
            "refine_hand_joints": out["refine_hand_joints"],
            "sample_pose_repr": sample,
        }

    def _device_batch(self, chunk: Sequence[dict[str, Any]]) -> dict[str, torch.Tensor]:
        batch = self._collate(chunk)
        db = {k: torch.as_tensor(batch[k]).to(self.device) for k in BATCH_KEYS}
        db["hand_side"] = db["hand_side"].long()
        db["text_emb"] = self.clip.encode_text(batch["text"])
        return db

    @torch.inference_mode()
    def generate(
        self,
        segments: Sequence[dict[str, Any]],
        generator: torch.Generator | None = None,
        noise: Sequence[tuple[torch.Tensor, torch.Tensor]] | None = None,
    ) -> list[dict[str, np.ndarray]]:
        """Run G -> R on per-segment sample dicts. Returns per segment
        refine_pose_repr [L, 99], verts [L, 778, 3], joints [L, 21, 3] and
        g_sample_pose_repr [L, 99].

        Noise comes from `generator` (a device generator seeded 0 when None),
        or, per batch of `batch_size` segments, from `noise[i]` = (x_T
        [bs, L, 99], per-step noise [T, bs, L, 99])."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        results: list[dict[str, np.ndarray]] = []
        for ci, start in enumerate(range(0, len(segments), self.batch_size)):
            chunk = list(segments[start : start + self.batch_size])
            n_real = len(chunk)
            chunk += [chunk[-1]] * (self.batch_size - n_real)  # pad to the batch shape
            x_t, steps = noise[ci] if noise is not None else (None, None)
            out = self._run(self._device_batch(chunk), generator, x_t, steps)
            out = {k: v.float().cpu().numpy() for k, v in out.items()}
            for i in range(n_real):
                results.append({
                    "refine_pose_repr": out["refine_pose_repr"][i],
                    "verts": out["refine_hand_verts"][i],
                    "joints": out["refine_hand_joints"][i],
                    "g_sample_pose_repr": out["sample_pose_repr"][i],
                })
        return results
