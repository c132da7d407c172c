"""Sequence (context) parallelism: Ulysses-style sharded attention.

The reference caps every chunk at ~1,875 mel frames and has no long-context
mechanism beyond application-level chunking (SURVEY §5). For sequences that
exceed one chip's activation budget — long chunks, or future
higher-resolution mel — this module shards the *frame axis* across the mesh
and runs attention with two all-to-alls (the DeepSpeed-Ulysses recipe):

    activations sharded [B, N/sp, ...] on axis `sp`
      ── all_to_all (scatter heads, gather frames) ──▶ [B, N, H/sp, D]
      ── full-sequence attention on local heads     ──▶ [B, N, H/sp, D]
      ── all_to_all (scatter frames, gather heads)  ──▶ [B, N/sp, H, D]

Head count must be divisible by the axis size (8 heads ÷ {2,4,8}). The
all-to-alls are the only communication; everything else in the DiT stays elementwise over
frames and needs no communication. Exposed as a drop-in attention function
over a ``shard_map``; correctness is tested against single-device attention
on the virtual CPU mesh (tests/test_parallel.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.attention import PLAIN, rope_attend, rotate


def sp_attention(
    q: jnp.ndarray,  # [B, N, H, D] — frame axis GLOBALLY sharded on `axis`
    k: jnp.ndarray,
    v: jnp.ndarray,
    cos: jnp.ndarray,
    sin: jnp.ndarray,
    mask: jnp.ndarray,
    mesh: Mesh,
    axis: str = "model",
    batch_axis: str | None = None,
    impl: str = PLAIN,
) -> jnp.ndarray:
    """Sequence-parallel attention, auto-selecting the algorithm:

    Ulysses (two all-to-alls, full-sequence local attention) when the head
    count divides the axis size — the cheaper pattern; the ppermute ring
    (online-softmax merge) otherwise. This is the dispatcher
    ``dit_forward_embedded`` calls when ``DiTConfig.seq_mesh`` is set.
    ``impl`` (``ops/attention.choose_attention``) is the attention Ulysses
    runs on its local heads; the ring runs its own online softmax."""
    sp = mesh.shape[axis]
    if q.shape[2] % sp == 0:
        return ulysses_attention(
            q, k, v, cos, sin, mask, mesh, axis, batch_axis, impl
        )
    return ring_attention(q, k, v, cos, sin, mask, mesh, axis, batch_axis)


def ulysses_attention(
    q: jnp.ndarray,  # [B, N, H, D] — frame axis GLOBALLY sharded on `axis`
    k: jnp.ndarray,
    v: jnp.ndarray,
    cos: jnp.ndarray,  # [N, D] rope tables (replicated)
    sin: jnp.ndarray,
    mask: jnp.ndarray,  # [B, N] bool (replicated over `axis`)
    mesh: Mesh,
    axis: str = "model",
    batch_axis: str | None = None,
    impl: str = PLAIN,
) -> jnp.ndarray:
    """Sequence-parallel multi-head RoPE attention → [B, N, H, D] sharded
    like ``q``. ``H % mesh.shape[axis] == 0`` required. ``batch_axis``
    additionally shards the batch dim (data parallelism composes)."""
    sp = mesh.shape[axis]
    h = q.shape[2]
    if h % sp != 0:
        raise ValueError(f"heads {h} not divisible by sequence-parallel size {sp}")

    def local(q_l, k_l, v_l, cos_r, sin_r, mask_r):
        # q_l: [B, N/sp, H, D] → gather frames / scatter heads.
        def a2a_fwd(x):
            return jax.lax.all_to_all(x, axis, split_axis=2, concat_axis=1, tiled=True)

        def a2a_bwd(x):
            return jax.lax.all_to_all(x, axis, split_axis=1, concat_axis=2, tiled=True)

        q_f = a2a_fwd(q_l)  # [B, N, H/sp, D]
        k_f = a2a_fwd(k_l)
        v_f = a2a_fwd(v_l)
        o = rope_attend(q_f, k_f, v_f, cos_r, sin_r, mask_r, impl)  # [B, N, H/sp, D]
        return a2a_bwd(o)  # [B, N/sp, H, D]

    spec_x = P(batch_axis, axis, None, None)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_x, spec_x, spec_x, P(), P(), P(batch_axis, None)),
        out_specs=spec_x,
    )
    return fn(q, k, v, cos, sin, mask)


def sequence_sharding(mesh: Mesh, axis: str = "model") -> NamedSharding:
    """Sharding for [B, N, ...] activations with the frame axis on ``axis``."""
    return NamedSharding(mesh, P(None, axis))


def ring_attention(
    q: jnp.ndarray,  # [B, N, H, D] — frame axis GLOBALLY sharded on `axis`
    k: jnp.ndarray,
    v: jnp.ndarray,
    cos: jnp.ndarray,  # [N, D] rope tables (replicated)
    sin: jnp.ndarray,
    mask: jnp.ndarray,  # [B, N] bool (replicated over `axis`)
    mesh: Mesh,
    axis: str = "model",
    batch_axis: str | None = None,
) -> jnp.ndarray:
    """Ring sequence-parallel attention → [B, N, H, D] sharded like ``q``.

    The complement to :func:`ulysses_attention` for when the head count is
    NOT divisible by the axis size (Ulysses' hard requirement): K/V blocks
    circulate around the ring via ``ppermute`` (one hop per step) while
    each device folds the visiting block into a running online softmax
    (max/sum/weighted-output accumulators — the flash-attention merge).
    Per device: sp matmul pairs of [N/sp, N/sp] instead of one [N/sp, N];
    communication overlaps compute because the permute for step s+1 is
    issued against data the current step no longer needs.
    """
    sp = mesh.shape[axis]
    b, n, h, d = q.shape
    if n % sp != 0:
        raise ValueError(f"frames {n} not divisible by ring size {sp}")

    def local(q_l, k_l, v_l, cos_l, sin_l, mask_l):
        # q_l/k_l/v_l: [B, n/sp, H, D]; cos_l/sin_l: [n/sp, D] — local rows;
        # mask_l: [B, n/sp] local key validity.
        # RoPE with GLOBAL positions (tables arrive pre-sharded like q); a
        # k block carries its rotation with it around the ring.
        q_b = jnp.moveaxis(rotate(q_l, cos_l, sin_l), 1, 2)  # [B,H,nl,D]
        k_b = jnp.moveaxis(rotate(k_l, cos_l, sin_l), 1, 2)
        v_b = jnp.moveaxis(v_l, 1, 2)
        scale = d**-0.5

        perm = [(i, (i + 1) % sp) for i in range(sp)]

        def step(carry, _):
            k_c, v_c, m_c, o_acc, l_acc, m_acc = carry
            s = (
                jnp.einsum(
                    "bhqd,bhkd->bhqk", q_b, k_c,
                    preferred_element_type=jnp.float32,
                )
                * scale
            )
            s = jnp.where(m_c[:, None, None, :], s, -1e30)
            m_new = jnp.maximum(m_acc, jnp.max(s, axis=-1))  # [B,H,nl]
            alpha = jnp.exp(m_acc - m_new)
            p = jnp.exp(s - m_new[..., None])
            l_new = l_acc * alpha + jnp.sum(p, axis=-1)
            o_new = o_acc * alpha[..., None] + jnp.einsum(
                "bhqk,bhkd->bhqd", p.astype(v_c.dtype), v_c,
                preferred_element_type=jnp.float32,
            )
            # Rotate K/V/mask to the next device for the following step.
            k_n = jax.lax.ppermute(k_c, axis, perm)
            v_n = jax.lax.ppermute(v_c, axis, perm)
            m_n = jax.lax.ppermute(m_c, axis, perm)
            return (k_n, v_n, m_n, o_new, l_new, m_new), None

        # Derive accumulators from q_b so shard_map types them as varying
        # over the ring axis (a plain jnp.zeros is unvarying and the scan
        # carry types would not match).
        o0 = jnp.zeros_like(q_b, jnp.float32)
        l0 = jnp.zeros_like(q_b[..., 0], jnp.float32)
        m0 = l0 - jnp.inf
        (_, _, _, o, l, _), _ = jax.lax.scan(
            step, (k_b, v_b, mask_l, o0, l0, m0), None, length=sp
        )
        o = o / jnp.maximum(l[..., None], 1e-30)
        return jnp.moveaxis(o.astype(q_l.dtype), 1, 2)  # [B, nl, H, D]

    spec_x = P(batch_axis, axis, None, None)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_x, spec_x, spec_x, P(axis), P(axis), P(batch_axis, axis)),
        out_specs=spec_x,
    )
    return fn(q, k, v, cos, sin, mask)
