"""Batch casting and placement (port of oakink2_tamf_tpu/utils/cast.py; the
reference dev_fn/transform/cast.py:76 `map_copy_select_to`, the
batch-to-device idiom of its launchers)."""

from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np
import torch


def map_copy_select_to(
    mapping: dict[str, Any],
    *,
    select: Iterable[str],
    dtype: Optional[torch.dtype] = None,
    device: Optional[str | torch.device] = None,
) -> dict[str, Any]:
    """Copy the selected keys of a host batch to tensors (floating ones cast
    to `dtype` when given, all moved to `device` when given: the JAX
    package's `sharding`); other keys pass through as they are."""
    select = set(select)
    out: dict[str, Any] = {}
    for k, v in mapping.items():
        if k in select:
            a = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            if dtype is not None and a.is_floating_point():
                a = a.to(dtype)
            if device is not None:
                a = a.to(device)
            out[k] = a
        else:
            out[k] = v
    return out
