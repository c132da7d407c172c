"""Rotary position embeddings.

The reference's ``preprocess.onnx`` graph emits four RoPE tables
(rope_cos_q/sin_q/cos_k/sin_k) that are threaded through every transformer
call (``/root/reference/vietvoicetts/core/tts_engine.py:148-172``). Here the
tables are precomputed once per frame bucket as a [N, head_dim] cos/sin pair
(q and k share tables for self-attention) and applied with the half-split
(GPT-NeoX) rotation, which keeps each half of the head dimension contiguous.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=32)
def rope_tables(seq_len: int, head_dim: int, theta: float = 10000.0):
    """Precompute (cos, sin), each [seq_len, head_dim], as host numpy.

    Returned as numpy (not jnp) on purpose: the cache may be populated inside
    a jit trace, and caching device arrays there would leak tracers. The
    half-dim frequency vector is duplicated across both halves so that
    ``apply_rope`` can use a single elementwise multiply per table.
    """
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))
    ang = np.arange(seq_len, dtype=np.float64)[:, None] * freqs[None, :]  # [N, half]
    cos = np.concatenate([np.cos(ang), np.cos(ang)], axis=-1).astype(np.float32)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return cos, sin


def rotate_half(x: jnp.ndarray) -> jnp.ndarray:
    """[..., d] → [..., d] with (x1, x2) → (-x2, x1) on the half split."""
    x1, x2 = jnp.split(x, 2, axis=-1)
    return jnp.concatenate([-x2, x1], axis=-1)


def apply_rope(x: jnp.ndarray, cos: jnp.ndarray, sin: jnp.ndarray) -> jnp.ndarray:
    """Rotate q or k: x [B, H, N, D], cos/sin [N, D] (broadcast over B, H)."""
    return x * cos + rotate_half(x) * sin
