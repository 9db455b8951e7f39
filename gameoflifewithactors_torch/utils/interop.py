"""Carrying grid state between the JAX package and this one.

A packed grid is the whole state of a run (with its rule and topology):
``(H, W/32)`` words for binary rules, a ``(b, H, W/32)`` bit-plane stack
for multi-state rules (Generations, Larger than Life with C >= 3); this
system has no weights. The JAX package stores packed words as uint32,
this package as int32 with the same bits (see ``ops/bitpack.py``), so the
hand-over is a reinterpreting view on the host:

    words = np.asarray(jax_engine.state)              # uint32 words or stack
    engine = Engine.from_packed(words, rule, topology=..., device=...)
    back = state_to_numpy(engine.state)               # uint32 again
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(words_u32: np.ndarray, device="cpu") -> torch.Tensor:
    """(H, W/32) words or a (b, H, W/32) stack, uint32 -> a new int32
    tensor on ``device``, bit for bit (the tensor never aliases the
    caller's buffer)."""
    words = np.asarray(words_u32)
    if words.ndim not in (2, 3):
        raise ValueError(
            f"packed words must be (H, W/32) or (b, H, W/32), got {words.shape}")
    if words.dtype not in (np.dtype("<u4"), np.dtype("<i4")):
        raise TypeError(f"packed words must be uint32 or int32, got {words.dtype}")
    host = np.ascontiguousarray(words).view(np.int32)
    return torch.from_numpy(host.copy()).to(device)


def state_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 packed words or plane stack (any device) -> a new host
    ``'<u4'`` array."""
    if t.dtype != torch.int32 or t.dim() not in (2, 3):
        raise TypeError(
            f"expected a 2D or 3D int32 packed tensor, got {t.dtype} "
            f"{tuple(t.shape)}")
    return t.detach().cpu().numpy().copy().view(np.dtype("<u4"))
