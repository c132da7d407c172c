"""Self-attention for the DiT denoiser.

The reference hides attention inside ``transformer.onnx``; here it is
explicit, so that the implementation can follow the device and heads can be
sharded over the ``model`` mesh axis. ``attention`` is the plain
implementation: f32 logits and softmax, whatever the compute dtype. It runs on
the CPU and for float32 everywhere, and it is the reference the fused path is
checked against (BASELINE numerics gate: mel atol 1e-2).
``choose_attention`` is the one place that decides which implementation a
program uses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -1e30

# Implementations ``choose_attention`` picks from.
PLAIN = "xla"
CUDNN = "cudnn"


def choose_attention(platform: str, dtype, head_dim: int) -> str:
    """The attention implementation for a device platform, compute dtype and
    head width.

    cuDNN's fused attention takes bf16 or fp16 with a head width that is a
    multiple of 8 up to 128; the plain path takes everything else: the CPU,
    float32 on the GPU (the reference numerics), and head widths outside
    that envelope."""
    if (
        platform == "gpu"
        and jnp.dtype(dtype) in (jnp.bfloat16, jnp.float16)
        and head_dim % 8 == 0
        and head_dim <= 128
    ):
        return CUDNN
    return PLAIN


def prefix_lengths(mask: jnp.ndarray) -> jnp.ndarray:
    """[B, N] bool validity mask → [B] int32 valid-frame counts.

    cuDNN takes lengths, not masks, which is only exact for a prefix mask
    (valid frames first). A concrete mask that is not a prefix is refused.
    Inside a jitted program the mask is a tracer and cannot be checked; there
    the invariant holds by construction: every mask the DiT sees is built as
    ``frame < length`` (``runtime/engine_core.py``, ``training/train.py``).
    """
    if not isinstance(mask, jax.core.Tracer):
        m = np.asarray(mask, bool)
        n = m.sum(axis=-1)
        if not (m == (np.arange(m.shape[-1]) < n[:, None])).all():
            raise ValueError("attention mask is not a prefix of valid frames")
    return jnp.sum(mask, axis=-1, dtype=jnp.int32)


def attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Bidirectional multi-head attention (the plain reference).

    q, k, v: [B, H, N, D]; mask: [B, N] bool (True = valid frame) or None.
    Returns [B, H, N, D] in q's dtype.
    """
    scale = q.shape[-1] ** -0.5
    logits = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * scale
    if mask is not None:
        bias = jnp.where(mask[:, None, None, :], 0.0, NEG_INF)
        logits = logits + bias
    weights = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", weights, v, preferred_element_type=jnp.float32).astype(q.dtype)


def attend(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    mask: jnp.ndarray,
    impl: str,
) -> jnp.ndarray:
    """Attention with the chosen implementation on [B, N, H, D] inputs that
    already carry RoPE; mask [B, N] bool. Returns [B, N, H, D].

    Query rows outside the mask are don't-care: cuDNN writes zeros there,
    the plain path attends from them as from any row."""
    if impl == CUDNN:
        # [B, N, H, D] is cuDNN's native layout: no transpose.
        lengths = prefix_lengths(mask)
        return jax.nn.dot_product_attention(
            q, k, v,
            query_seq_lengths=lengths,
            key_value_seq_lengths=lengths,
            implementation="cudnn",
        )
    if impl != PLAIN:
        raise ValueError(f"unknown attention implementation {impl!r}")
    out = attention(*(jnp.moveaxis(x, 1, 2) for x in (q, k, v)), mask)
    return jnp.moveaxis(out, 1, 2)


def rotate(x: jnp.ndarray, cos: jnp.ndarray, sin: jnp.ndarray) -> jnp.ndarray:
    """RoPE on [B, N, H, D] with cos/sin [N, D], computed in f32 and rounded
    once to x's dtype; XLA fuses it into a single elementwise pass."""
    from .rope import apply_rope

    c = cos.astype(jnp.float32)[:, None]
    s = sin.astype(jnp.float32)[:, None]
    return apply_rope(x.astype(jnp.float32), c, s).astype(x.dtype)


def rope_attend(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    cos: jnp.ndarray,
    sin: jnp.ndarray,
    mask: jnp.ndarray,
    impl: str,
) -> jnp.ndarray:
    """RoPE on q and k, then attention with the chosen implementation: the
    one attention step of every DiT block, single-device or sequence
    parallel. q, k, v [B, N, H, D]; cos/sin [N, D]; mask [B, N] bool."""
    return attend(rotate(q, cos, sin), rotate(k, cos, sin), v, mask, impl)


def packed_rope_attention(
    qkv: jnp.ndarray,
    cos: jnp.ndarray,
    sin: jnp.ndarray,
    mask: jnp.ndarray,
    heads: int,
    impl: str,
) -> jnp.ndarray:
    """RoPE attention on the packed projection ``[B, N, 3·H·D]`` laid out as
    ``[q_heads ‖ k_heads ‖ v_heads]``; cos/sin [N, D]; mask [B, N] bool.

    Returns [B, N, H·D] in qkv's dtype, ready for the out-projection."""
    b, n, width = qkv.shape
    hd = width // (3 * heads)
    q, k, v = (x.reshape(b, n, heads, hd) for x in jnp.split(qkv, 3, axis=-1))
    return rope_attend(q, k, v, cos, sin, mask, impl).reshape(b, n, heads * hd)
