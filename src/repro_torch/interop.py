"""Carry executor state between the JAX package and the port.

The system has no weights: its state IS the data.  Both executors keep a
state dict of raw storage keyed by tensor and result name, with identical
storage shapes (the layout solver and ``aosoa_tile`` are the same), so a
reference state converts entry by entry.  NumPy arrays are the medium:
``{k: np.asarray(v) for k, v in jax_state.items()}`` on the way in.

A bfloat16 array from JAX has NumPy dtype ``bfloat16`` (registered by the
``ml_dtypes`` package), which ``torch.from_numpy`` refuses; its bits go
across as ``int16`` and are reinterpreted on the other side.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["state_from_reference", "state_to_reference"]


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def state_from_reference(state_np: Mapping[str, np.ndarray],
                         device: Any) -> dict[str, torch.Tensor]:
    """Torch state on ``device`` from a reference state of NumPy arrays;
    keys, shapes and values are kept (bfloat16 bit for bit)."""
    out = {}
    for k, v in state_np.items():
        v = np.array(v, order="C")   # a writable copy: torch shares it
        if _is_bf16(v.dtype):
            t = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(v)
        out[k] = t.to(device)
    return out


def state_to_reference(state: Mapping[str, torch.Tensor]
                       ) -> dict[str, np.ndarray]:
    """NumPy arrays from a port state, the inverse of
    :func:`state_from_reference`.  A bfloat16 entry becomes a NumPy
    ``bfloat16`` array, which needs ``ml_dtypes`` loaded in the process
    (importing JAX loads it)."""
    out = {}
    for k, t in state.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            try:
                bf16 = np.dtype("bfloat16")
            except TypeError as exc:
                raise TypeError(f"{k}: a bfloat16 entry needs NumPy's "
                                f"bfloat16 dtype (ml_dtypes)") from exc
            out[k] = t.view(torch.int16).numpy().view(bf16)
        else:
            out[k] = t.numpy()
    return out
