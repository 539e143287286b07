"""Carry executor state and LM weights between the JAX package and the
port.

The graph workloads have no weights: their state IS the data.  Both
executors keep a
state dict of raw storage keyed by tensor and result name, with identical
storage shapes (the layout solver and ``aosoa_tile`` are the same), so a
reference state converts entry by entry.  NumPy arrays are the medium:
``{k: np.asarray(v) for k, v in jax_state.items()}`` on the way in.
The LM's weights go across with :func:`params_from_reference`.

A bfloat16 array from JAX has NumPy dtype ``bfloat16`` (registered by the
``ml_dtypes`` package), which ``torch.from_numpy`` refuses; its bits go
across as ``int16`` and are reinterpreted on the other side.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["state_from_reference", "state_to_reference",
           "params_from_reference"]


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def _from_numpy(v) -> torch.Tensor:
    v = np.array(v, order="C")   # a writable copy: torch shares it
    if _is_bf16(v.dtype):
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(v)


def state_from_reference(state_np: Mapping[str, np.ndarray],
                         device: Any) -> dict[str, torch.Tensor]:
    """Torch state on ``device`` from a reference state of NumPy arrays;
    keys, shapes and values are kept (bfloat16 bit for bit)."""
    return {k: _from_numpy(v).to(device) for k, v in state_np.items()}


def params_from_reference(params_np: Mapping[str, Any], cfg,
                          device: Any) -> torch.nn.Module:
    """The port's LM module on ``device`` holding the weights of a JAX
    ``init_lm`` tree (nested dicts of NumPy arrays).  The JAX tree stacks
    the layer groups, and an encoder's layers, on a leading axis
    (``groups/p0/attn/wq[g]``, ``encoder/p0/attn/wq[e]``); the port names
    the same weights ``groups.g.p0.attn.wq`` and ``encoder.e.p0.attn.wq``.
    Values are kept, bfloat16 bit for bit."""
    from .models.lm import init_lm

    lm = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for name, param in lm.named_parameters():
            parts = name.split(".")
            leaf: Any = params_np
            group = None
            for part in parts:
                if part.isdigit():
                    group = int(part)
                else:
                    leaf = leaf[part]
            value = _from_numpy(leaf if group is None else leaf[group])
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: reference shape "
                                 f"{tuple(value.shape)} != "
                                 f"{tuple(param.shape)}")
            param.copy_(value.to(param.dtype))
    return lm.to(device)


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
