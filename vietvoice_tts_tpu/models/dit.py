"""Flow-matching DiT denoiser (the reference's ``transformer.onnx``).

The reference executes one opaque ONNX denoise step per Python-loop
iteration (``/root/reference/vietvoicetts/core/tts_engine.py:148-174``).
Here the step is an explicit JAX function:

- **AdaLN-Zero** conditioning from the flow time: each block's modulation
  (shift/scale/gate for attention and FFN) comes from one small matmul on
  the time embedding; gates are zero-initialized so the residual trunk is
  the identity at init.
- **Blocks stacked on a leading depth axis** and run with ``lax.scan`` —
  one traced body instead of ``depth`` inlined copies (~10× faster XLA
  compile, identical math, and the stacked weights give the tensor-parallel
  sharder a single leaf per matmul: ``parallel/sharding.py``).
- **Packed QKV** ``[q_heads ‖ k_heads ‖ v_heads]`` along the feature dim;
  ``ops/attention.packed_rope_attention`` takes ``[B, N, H, D]`` views of
  it, with the implementation ``ops/attention.choose_attention`` picks.
- **bf16 matmuls, f32 softmax/norms**: `compute_dtype` applies to the matmul
  work; normalization, modulation, and the output are float32 (BASELINE
  numerics gate: mel atol 1e-2 vs the reference).
- Text and mel share the sequence axis (F5-style): character IDs are padded
  with ``-1`` to the mel frame bucket, embedded through a small ConvNeXt
  stack, and concatenated with (noisy latent, conditioning mel) per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.attention import choose_attention, packed_rope_attention
from ..ops.rope import rope_tables

Params = Dict[str, Any]

TIME_FREQ_DIM = 256  # sinusoidal feature width for the flow time
CONV_POS_KERNEL = 31
TEXT_CONV_KERNEL = 7


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    dim: int = 1024
    depth: int = 22
    heads: int = 8
    ff_mult: int = 2
    n_mels: int = 100
    text_dim: int = 512
    text_conv_layers: int = 4
    vocab_size: int = 256
    compute_dtype: Any = jnp.bfloat16
    # LayerNorm statistics dtype: f32 default; bf16 is an opt-in
    # (less norm traffic, more mel drift; config.py).
    norm_dtype: Any = jnp.float32
    # Sequence (context) parallelism: when ``seq_mesh`` is a jax Mesh, the
    # frame axis of every activation is sharded over ``seq_axis`` and
    # attention runs via parallel/sequence.sp_attention (Ulysses when heads
    # divide the axis size, ppermute ring otherwise). ``seq_batch_axis``
    # optionally composes data parallelism on the batch dim. Params must be
    # replicated over ``seq_axis`` (the axis is spent on frames, not TP).
    seq_mesh: Any = None
    seq_axis: str = "model"
    seq_batch_axis: Any = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _as_rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def _dense(rng: np.random.Generator, fan_in: int, fan_out: int, *lead: int):
    """LeCun-normal weight [*, fan_in, fan_out] + zero bias."""
    std = 1.0 / np.sqrt(fan_in)
    w = rng.normal(0.0, std, (*lead, fan_in, fan_out)).astype(np.float32)
    b = np.zeros((*lead, fan_out), np.float32)
    return {"w": w, "b": b}


def _text_block(rng: np.random.Generator, dim: int) -> dict:
    inter = 2 * dim
    k = TEXT_CONV_KERNEL
    return {
        "dwconv": {
            "w": rng.normal(0.0, 1.0 / np.sqrt(k), (k, 1, dim)).astype(np.float32),
            "b": np.zeros((dim,), np.float32),
        },
        "pw1": _dense(rng, dim, inter),
        "pw2": _dense(rng, inter, dim),
    }


def init_dit_params(seed, cfg: DiTConfig) -> Params:
    """Random-init parameter pytree (numpy float32 leaves).

    ``seed`` may be an int or a ``np.random.Generator``. Tree structure must
    stay in lockstep with ``parallel/sharding.param_pspecs``.
    """
    rng = _as_rng(seed)
    d, depth = cfg.dim, cfg.depth

    # AdaLN-Zero: modulation projections start at exactly zero so every
    # block is the identity at init and gates open during training.
    ada = {
        "w": np.zeros((depth, d, 6 * d), np.float32),
        "b": np.zeros((depth, 6 * d), np.float32),
    }
    blocks = {
        "ada": ada,
        "qkv": _dense(rng, d, 3 * d, depth),
        "attn_out": _dense(rng, d, d, depth),
        "ff1": _dense(rng, d, cfg.ff_mult * d, depth),
        "ff2": _dense(rng, cfg.ff_mult * d, d, depth),
    }
    # Convolutional position embedding as depthwise(k=31) → Mish →
    # pointwise: the depthwise taps are shifted multiply-adds and the
    # channel mixing is one dense matmul.
    k = CONV_POS_KERNEL
    conv_pos: List[dict] = [
        {
            "w": rng.normal(0.0, 1.0 / np.sqrt(k), (k, 1, d)).astype(np.float32),
            "b": np.zeros((d,), np.float32),
        },
        _dense(rng, d, d),
    ]
    return {
        "text_embed": {
            # Row 0 is the filler token (pad id -1 → index 0, like the
            # reference's unk→0 mapping, text_processor.py:30-37).
            "table": (
                rng.normal(0.0, 0.02, (cfg.vocab_size + 1, cfg.text_dim))
            ).astype(np.float32),
            "blocks": [_text_block(rng, cfg.text_dim) for _ in range(cfg.text_conv_layers)],
        },
        "time_embed": {
            "mlp1": _dense(rng, TIME_FREQ_DIM, d),
            "mlp2": _dense(rng, d, d),
        },
        "input_proj": _dense(rng, 2 * cfg.n_mels + cfg.text_dim, d),
        "conv_pos": conv_pos,
        "blocks": blocks,
        "final_ada": {
            "w": np.zeros((d, 2 * d), np.float32),
            "b": np.zeros((2 * d,), np.float32),
        },
        "final_proj": _dense(rng, d, cfg.n_mels),
    }


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _layernorm(x: jnp.ndarray, stats_dtype=jnp.float32) -> jnp.ndarray:
    """Non-affine LayerNorm (AdaLN supplies scale/shift); returns f32.

    ``stats_dtype`` sets the mean/variance math: f32 default; bf16 skips
    the upcast passes over the [B, N, dim] stream at extra mel drift —
    opt-in via config.norm_dtype."""
    xs = x.astype(stats_dtype)
    mu = jnp.mean(xs, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(xs - mu), axis=-1, keepdims=True)
    return ((xs - mu) * jax.lax.rsqrt(var + 1e-6)).astype(jnp.float32)


def _mish(x: jnp.ndarray) -> jnp.ndarray:
    return x * jnp.tanh(jax.nn.softplus(x))


def _text_convnext(p: dict, x: jnp.ndarray, dtype) -> jnp.ndarray:
    """ConvNeXt-1D residual block on the text embedding. x: [B, N, C] f32."""
    from .vocoder import _dwconv  # shared shifted-add depthwise conv

    h = _dwconv(p["dwconv"], x)
    h = _layernorm(h).astype(dtype)
    h = jax.nn.gelu(h @ p["pw1"]["w"].astype(dtype) + p["pw1"]["b"].astype(dtype))
    h = h @ p["pw2"]["w"].astype(dtype) + p["pw2"]["b"].astype(dtype)
    return x + h.astype(jnp.float32)


def _conv_pos_embed(conv_pos: list, h: jnp.ndarray) -> jnp.ndarray:
    """Depthwise(k=31) → Mish → pointwise position embedding. h: [B, N, C].

    Weights are cast to the stream dtype up front — f32 weights would
    silently promote the whole residual stream to f32 (jnp promotion) and
    double its HBM traffic."""
    from .vocoder import _dwconv

    dw = {
        "w": conv_pos[0]["w"].astype(h.dtype),
        "b": conv_pos[0]["b"].astype(h.dtype),
    }
    pos = _mish(_dwconv(dw, h))
    pw = conv_pos[1]
    return pos @ pw["w"].astype(h.dtype) + pw["b"].astype(h.dtype)


def _time_embedding(p: dict, t: jnp.ndarray) -> jnp.ndarray:
    """Sinusoidal features of the flow time → MLP. t: [B] f32 → [B, dim]."""
    half = TIME_FREQ_DIM // 2
    freqs = jnp.exp(
        -jnp.log(10000.0) * jnp.arange(half, dtype=jnp.float32) / half
    )
    args = t.astype(jnp.float32)[:, None] * freqs[None, :] * 1000.0
    feats = jnp.concatenate([jnp.cos(args), jnp.sin(args)], axis=-1)
    h = jax.nn.silu(feats @ p["mlp1"]["w"] + p["mlp1"]["b"])
    return h @ p["mlp2"]["w"] + p["mlp2"]["b"]  # [B, dim] f32


def scanned_blocks(params: Params) -> Dict[str, Any]:
    """The stacked-depth block leaves the forward SCANS over — everything
    under ``params['blocks']`` except ``ada`` (consumed hoisted, outside
    the scan). The deep-cache sampler pre-slices this same tree; a single
    definition keeps the two views in lockstep if another non-scanned key
    ever lands next to ``ada``."""
    return {k: v for k, v in params["blocks"].items() if k != "ada"}


def dit_time_modulations(params: Params, cfg: DiTConfig, t: jnp.ndarray):
    """AdaLN modulations for a batch of flow times t [S] → ([S, depth, 6d],
    [S, 2d]).

    Hoistable across the NFE solve: the modulation depends only on t, and
    the sampler's time grid is static — computing all steps' modulations
    BEFORE the step scan reads the ada weight stack ([depth, d, 6d],
    ~270 MB in bf16 at full size) ONCE per solve instead of once per step.
    At 31 evals that removes ~8 GB of weight reads per solve. FLOPs are
    unchanged; accumulation stays f32 like the in-block matmul it
    replaces."""
    t_emb = jax.nn.silu(_time_embedding(params["time_embed"], t))  # [S, d] f32
    ada = params["blocks"]["ada"]
    mods = (
        jnp.einsum("sd,ldm->slm", t_emb, ada["w"])
        + ada["b"][None].astype(jnp.float32)
    )  # [S, depth, 6d] f32
    fmod = t_emb @ params["final_ada"]["w"] + params["final_ada"]["b"]  # [S, 2d]
    return mods, fmod


def dit_text_embed(params: Params, cfg: DiTConfig, text_ids: jnp.ndarray) -> jnp.ndarray:
    """Character IDs → per-frame text features [B, N, text_dim] (f32).

    Hoistable: the sampler calls this ONCE and reuses the result across all
    NFE steps (it does not depend on x or t)."""
    dtype = cfg.compute_dtype
    table = params["text_embed"]["table"]
    emb = jnp.take(table, jnp.clip(text_ids + 1, 0, cfg.vocab_size), axis=0)
    emb = emb.astype(jnp.float32)
    for blk in params["text_embed"]["blocks"]:
        emb = _text_convnext(blk, emb, dtype)
    return emb


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def dit_forward_embedded(
    params: Params,
    cfg: DiTConfig,
    x: jnp.ndarray,  # [B, N, n_mels] noisy latent
    cond: jnp.ndarray,  # [B, N, n_mels] masked-infill conditioning mel
    text_emb: jnp.ndarray,  # [B, N, text_dim] from dit_text_embed
    t: jnp.ndarray,  # [B] flow time in [0, 1]
    mask: jnp.ndarray,  # [B, N] bool, True = valid frame
    time_mod=None,  # optional precomputed (mods [depth, B', 6d], fmod [B', 2d])
    shallow_blocks: int | None = None,  # deep-cache split point (static)
    deep_state: jnp.ndarray | None = None,  # cached deep-trunk residual
    return_deep_state: bool = False,
    presplit_blocks=None,  # optional (shallow_tree, deep_tree), pre-sliced
):
    """Predict the flow velocity field; masked frames return exactly 0.

    ``time_mod`` lets the sampler hoist the AdaLN modulation across the NFE
    solve (``dit_time_modulations``): B' may be 1 (all rows share one t —
    the inference case) and broadcasts over the batch. When None the
    modulation is computed here from ``t`` per row (training path).

    **Deep-block caching** (training-free NFE acceleration, TeaCache /
    Δ-DiT family — opt-in via the sampler): with ``shallow_blocks=j``,

    - ``return_deep_state=True`` runs ALL blocks but also returns the deep
      trunk's residual contribution ``h_L − h_j`` (a ``(out, state)``
      tuple) — the quantity that drifts slowly between adjacent flow
      times;
    - ``deep_state=state`` runs only blocks ``0..j`` on the fresh input
      and substitutes the cached deep contribution (``h ≈ h_j + state``),
      skipping ``depth − j`` blocks of compute.

    The split is static, so each variant is its own XLA program."""
    dtype = cfg.compute_dtype
    b, n, _ = x.shape
    mask_f = mask[..., None].astype(jnp.float32)

    # Zero padding frames on the way in so convs can't leak garbage inward.
    h_in = jnp.concatenate(
        [
            x.astype(jnp.float32) * mask_f,
            cond.astype(jnp.float32) * mask_f,
            text_emb * mask_f,
        ],
        axis=-1,
    ).astype(dtype)
    p_in = params["input_proj"]
    h = h_in @ p_in["w"].astype(dtype) + p_in["b"].astype(dtype)  # [B, N, dim]

    if cfg.seq_mesh is not None:
        # Sequence parallelism: pin the residual stream frame-sharded so
        # every elementwise/matmul op partitions over frames (GSPMD handles
        # the conv halo exchange); attention is the only op that needs
        # cross-frame communication and goes through sp_attention below.
        from jax.sharding import NamedSharding, PartitionSpec

        h = jax.lax.with_sharding_constraint(
            h,
            NamedSharding(
                cfg.seq_mesh, PartitionSpec(cfg.seq_batch_axis, cfg.seq_axis, None)
            ),
        )

    # Convolutional position embedding (depthwise → Mish → pointwise).
    h = (h + _conv_pos_embed(params["conv_pos"], h)) * mask_f.astype(dtype)

    if time_mod is None:
        # Per-row modulation from t (training: each row has its own time).
        t_emb = jax.nn.silu(_time_embedding(params["time_embed"], t))  # [B, dim]
        ada = params["blocks"]["ada"]
        mods = (
            jnp.einsum("bd,ldm->lbm", t_emb, ada["w"])
            + ada["b"][:, None].astype(jnp.float32)
        )  # [depth, B, 6d] f32
        fmod = t_emb @ params["final_ada"]["w"] + params["final_ada"]["b"]
    else:
        mods, fmod = time_mod  # [depth, B', 6d], [B', 2d]; B' broadcasts

    cos_np, sin_np = rope_tables(n, cfg.head_dim)
    cos, sin = jnp.asarray(cos_np), jnp.asarray(sin_np)
    heads, hd = cfg.heads, cfg.head_dim
    attn_impl = choose_attention(jax.default_backend(), dtype, hd)

    # ada is consumed above (hoisted out of the scan); dropping it from the
    # scanned pytree keeps the loop body free of dead weight slices.
    blocks_scan = scanned_blocks(params)

    def modulated_norm(h, sc, sh):
        # sc/sh: [B', dim] f32; B' = 1 broadcasts over the batch.
        return (
            _layernorm(h, cfg.norm_dtype) * (1.0 + sc[:, None]) + sh[:, None]
        ).astype(dtype)

    def block(h, xs):
        # h: [B, N, dim] residual stream in compute_dtype (norm math is f32;
        # keeping the stream bf16 halves its memory traffic).
        blk, mod = xs  # mod: [B', 6·dim] f32
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = jnp.split(mod, 6, axis=-1)

        u = modulated_norm(h, sc_a, sh_a)
        qkv = u @ blk["qkv"]["w"].astype(dtype) + blk["qkv"]["b"].astype(dtype)
        if cfg.seq_mesh is not None:
            from ..parallel.sequence import sp_attention

            q, k, v = jnp.split(qkv, 3, axis=-1)
            attn = sp_attention(
                q.reshape(b, n, heads, hd),
                k.reshape(b, n, heads, hd),
                v.reshape(b, n, heads, hd),
                cos,
                sin,
                mask,
                mesh=cfg.seq_mesh,
                axis=cfg.seq_axis,
                batch_axis=cfg.seq_batch_axis,
                impl=attn_impl,
            ).reshape(b, n, heads * hd)
        else:
            attn = packed_rope_attention(qkv, cos, sin, mask, heads, attn_impl)
        attn = attn @ blk["attn_out"]["w"].astype(dtype) + blk["attn_out"]["b"].astype(
            dtype
        )
        h = h + g_a[:, None].astype(dtype) * attn

        u = modulated_norm(h, sc_f, sh_f)
        f = jax.nn.gelu(u @ blk["ff1"]["w"].astype(dtype) + blk["ff1"]["b"].astype(dtype))
        f = f @ blk["ff2"]["w"].astype(dtype) + blk["ff2"]["b"].astype(dtype)
        h = h + g_f[:, None].astype(dtype) * f
        return h, None

    deep_out = None
    if shallow_blocks is None:
        h, _ = jax.lax.scan(block, h, (blocks_scan, mods))
    else:
        j = int(shallow_blocks)
        if not 1 <= j < cfg.depth:
            raise ValueError(
                f"shallow_blocks={j} must be in [1, depth={cfg.depth})"
            )
        if presplit_blocks is not None:
            # Caller pre-sliced the stacked weights OUTSIDE its step scan:
            # slicing here, inside a scanned body, makes XLA re-materialize
            # the sliced weight copies every loop iteration.
            shallow, deep = presplit_blocks
        else:
            shallow = jax.tree.map(lambda a: a[:j], blocks_scan)
            deep = jax.tree.map(lambda a: a[j:], blocks_scan)
        h, _ = jax.lax.scan(block, h, (shallow, mods[:j]))
        if deep_state is not None:
            h = h + deep_state.astype(h.dtype)
        else:
            h_deep, _ = jax.lax.scan(block, h, (deep, mods[j:]))
            deep_out = h_deep - h
            h = h_deep

    sh, sc = jnp.split(fmod, 2, axis=-1)
    h = _layernorm(h) * (1.0 + sc[:, None]) + sh[:, None]
    out = h @ params["final_proj"]["w"] + params["final_proj"]["b"]  # f32
    out = jnp.where(mask[..., None], out, 0.0)
    if return_deep_state:
        return out, deep_out
    return out


def dit_forward(
    params: Params,
    cfg: DiTConfig,
    x: jnp.ndarray,
    cond: jnp.ndarray,
    text_ids: jnp.ndarray,
    t: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """Full forward: embed text then denoise. See ``dit_forward_embedded``."""
    text_emb = dit_text_embed(params, cfg, text_ids)
    return dit_forward_embedded(params, cfg, x, cond, text_emb, t, mask)
