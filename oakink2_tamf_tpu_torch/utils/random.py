"""Uniform random rotations (port of oakink2_tamf_tpu/utils/random.py; the
reference dev_fn/transform/random.py).

Shoemake's subgroup method, in the JAX package's order: u1 on [0, 1), then
the angles u2 and u3 on [0, 2 pi), drawn from a torch.Generator (the JAX
package draws from split keys, so the draws differ; `quat_from_uniforms`
is the same map from uniforms to quaternions)."""

from __future__ import annotations

import math

import torch

from ..core.transforms import quat_to_rotmat


def quat_from_uniforms(u1: torch.Tensor, u2: torch.Tensor, u3: torch.Tensor) -> torch.Tensor:
    """Shoemake: u1 in [0, 1), angles u2, u3 in [0, 2 pi) -> unit
    quaternions (w, x, y, z) [..., 4]."""
    a = torch.sqrt(1.0 - u1)
    b = torch.sqrt(u1)
    return torch.stack((b * torch.cos(u3), a * torch.sin(u2), a * torch.cos(u2), b * torch.sin(u3)), dim=-1)


def random_quat(generator: torch.Generator | None = None, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """Uniform unit quaternions (w, x, y, z) [*shape, 4] (float32) on the
    generator's device (the default generator's, on the CPU, when None)."""
    device = generator.device if generator is not None else None
    u1, u2, u3 = (torch.rand(tuple(shape), generator=generator, device=device) for _ in range(3))
    return quat_from_uniforms(u1, u2 * (2 * math.pi), u3 * (2 * math.pi))


def random_rotmat(generator: torch.Generator | None = None, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """Uniform rotation matrices [*shape, 3, 3]."""
    return quat_to_rotmat(random_quat(generator, shape))
