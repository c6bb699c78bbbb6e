"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit), and the card's power limit as nvidia-smi reads it.

The configurations compute in float32 with TF32 off, so a share of the peak
is taken against the FP32 rate outside the tensor cores."""

from __future__ import annotations

import subprocess

FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def power_limit_w() -> float | None:
    """The first card's power limit in watts, or None where nvidia-smi cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
