"""Diffusion timestep samplers (port of oakink2_tamf_tpu/core/schedule_sampler.py;
reference model/diffusion/resample.py).

- UniformSampler: uniform t, what every TaMF config uses.
- LossSecondMomentResampler: importance-samples t by the second moment of
  each timestep's recent losses; the history lives on the host.

Both draw from a `torch.Generator`. The same seed gives other numbers than
the JAX package's keys: tests compare the weights and the distributions.
"""

from __future__ import annotations

import numpy as np
import torch


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")


class UniformSampler:
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, batch: int, *, generator: torch.Generator | None = None,
               device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
        """(t [batch] int64, weights [batch] float32)."""
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator, device=device)
        return t, torch.ones((batch,), dtype=torch.float32, device=device)

    def update_with_losses(self, t, losses) -> None:  # no history for uniform
        pass


class LossSecondMomentResampler:
    """Host-side importance sampler over timesteps (resample.py:119-147)."""

    def __init__(self, num_timesteps: int, history_per_term: int = 10, uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros((num_timesteps, history_per_term), dtype=np.float64)
        self._loss_counts = np.zeros((num_timesteps,), dtype=np.int64)

    def _warmed_up(self) -> bool:
        return bool((self._loss_counts == self.history_per_term).all())

    def weights(self) -> np.ndarray:
        if not self._warmed_up():
            return np.ones((self.num_timesteps,), dtype=np.float64)
        w = np.sqrt(np.mean(self._loss_history**2, axis=-1))
        w = w / w.sum()
        w = w * (1 - self.uniform_prob)
        return w + self.uniform_prob / len(w)

    def sample(self, batch: int, *, generator: torch.Generator | None = None,
               device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
        """(t [batch] int64, importance weights [batch] float32) on `device`;
        drawn on the generator's device (the CPU for a host generator)."""
        w = self.weights()
        p = torch.from_numpy(w / w.sum()).to(torch.float32)
        t = torch.multinomial(p, batch, replacement=True, generator=generator)
        w = 1.0 / (len(p) * p[t])
        return t.to(device), w.to(device)

    def update_with_losses(self, t, losses) -> None:
        """t, losses: per-sample host arrays (or tensors) of the last step."""
        t = np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
        losses = np.asarray(losses.detach().cpu() if isinstance(losses, torch.Tensor) else losses)
        for ti, li in zip(t.tolist(), losses.tolist()):
            if self._loss_counts[ti] == self.history_per_term:
                self._loss_history[ti, :-1] = self._loss_history[ti, 1:]
                self._loss_history[ti, -1] = li
            else:
                self._loss_history[ti, self._loss_counts[ti]] = li
                self._loss_counts[ti] += 1
