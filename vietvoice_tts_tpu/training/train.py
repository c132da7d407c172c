"""Conditional flow-matching training for the DiT mel generator.

Objective (F5-TTS family): draw t ~ U[0,1], noise x₀, data x₁ (ground-truth
mel); the network predicts the straight-line velocity field v = x₁ − x₀ from
x_t = (1−t)·x₀ + t·x₁, conditioned on a randomly span-masked copy of the mel
(infilling) and the character sequence. Conditioning is dropped with
probability ``cfg_dropout`` to train the classifier-free-guidance branch the
sampler uses (``models/sampler.py``).

Everything is one jittable ``train_step`` over (params, opt_state, batch):
data-parallel over the ``data`` mesh axis and tensor-parallel over ``model``
via the same NamedShardings as inference (``parallel/sharding.py``) — XLA
inserts the gradient ``psum``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import optax

from ..models.dit import DiTConfig, dit_forward

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 1000
    max_grad_norm: float = 1.0
    cfg_dropout: float = 0.1  # P(drop cond+text) per sample
    min_span_frac: float = 0.7  # masked-infill span, fraction of target
    max_span_frac: float = 1.0
    # Mixed precision: "bfloat16" runs the DiT's matmul/attention compute in
    # bf16 while the params handed to the optimizer — the master weights —
    # and Adam moments stay float32 (the forward casts weights per-use, so
    # gradients come out f32; bf16 needs no loss scaling thanks to its f32
    # exponent range). "float32" is the bit-exact reference path.
    compute_dtype: str = "float32"


def make_optimizer(cfg: TrainConfig) -> optax.GradientTransformation:
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=cfg.warmup_steps,
        decay_steps=1_000_000,
        end_value=cfg.learning_rate * 0.1,
    )
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.adamw(schedule, weight_decay=cfg.weight_decay),
    )


def flow_matching_loss(
    params: Params,
    dit_cfg: DiTConfig,
    key: jax.Array,
    mel: jnp.ndarray,  # [B, N, n_mels] ground-truth log-mel
    text_ids: jnp.ndarray,  # [B, N] int32, -1 padded
    lengths: jnp.ndarray,  # [B] int32 valid frames
    train_cfg: TrainConfig,
) -> jnp.ndarray:
    b, n, m = mel.shape
    k_t, k_x0, k_span, k_frac, k_drop = jax.random.split(key, 5)

    frame_idx = jnp.arange(n, dtype=jnp.int32)
    valid = frame_idx[None, :] < lengths[:, None]  # [B, N]

    t = jax.random.uniform(k_t, (b,), jnp.float32)
    x0 = jax.random.normal(k_x0, (b, n, m), jnp.float32)
    x1 = mel.astype(jnp.float32)
    xt = (1.0 - t[:, None, None]) * x0 + t[:, None, None] * x1
    v_target = x1 - x0

    # Span-masked infilling: a contiguous masked region per sample; the
    # network sees the unmasked mel as conditioning and is scored only on the
    # masked frames.
    frac = jax.random.uniform(
        k_frac, (b,), jnp.float32, train_cfg.min_span_frac, train_cfg.max_span_frac
    )
    span_len = (frac * lengths.astype(jnp.float32)).astype(jnp.int32)
    max_start = jnp.maximum(lengths - span_len, 1)
    start = (
        jax.random.uniform(k_span, (b,), jnp.float32) * max_start.astype(jnp.float32)
    ).astype(jnp.int32)
    in_span = (frame_idx[None, :] >= start[:, None]) & (
        frame_idx[None, :] < (start + span_len)[:, None]
    )
    infill_mask = in_span & valid  # [B, N] — scored region
    cond = jnp.where((valid & ~in_span)[..., None], x1, 0.0)

    # CFG dropout: drop cond and text together per sample.
    drop = jax.random.bernoulli(k_drop, train_cfg.cfg_dropout, (b,))
    cond = jnp.where(drop[:, None, None], 0.0, cond)
    text_ids = jnp.where(drop[:, None], -1, text_ids)

    v_pred = dit_forward(params, dit_cfg, xt, cond, text_ids, t, valid)
    err = (v_pred - v_target) ** 2
    w = infill_mask[..., None].astype(jnp.float32)
    return jnp.sum(err * w) / jnp.maximum(jnp.sum(w) * m, 1.0) * m


def init_train_state(params: Params, train_cfg: TrainConfig):
    return make_optimizer(train_cfg).init(params)


def make_train_step(dit_cfg: DiTConfig, train_cfg: TrainConfig):
    """Build the jittable (params, opt_state, key, batch) → updated state.

    ``train_cfg.compute_dtype`` overrides the DiT's compute dtype for the
    forward/backward pass (bf16 matmuls, f32 master weights + optimizer)."""
    optimizer = make_optimizer(train_cfg)
    dit_cfg = dataclasses.replace(
        dit_cfg, compute_dtype=jnp.dtype(train_cfg.compute_dtype)
    )

    def train_step(
        params: Params,
        opt_state,
        key: jax.Array,
        mel: jnp.ndarray,
        text_ids: jnp.ndarray,
        lengths: jnp.ndarray,
    ) -> Tuple[Params, Any, jnp.ndarray]:
        loss, grads = jax.value_and_grad(flow_matching_loss)(
            params, dit_cfg, key, mel, text_ids, lengths, train_cfg
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step
