"""Vocos-style neural vocoder (the reference's ``decode.onnx``).

The reference's vocoder is an opaque graph run once per chunk
(reference ``vietvoicetts/core/tts_engine.py:176-187``). Here it is
built from matmuls and elementwise ops:

- **ConvNeXt-1D trunk**: depthwise conv (shifted-add rewrite — seven
  elementwise multiply-adds instead of a grouped conv), LayerNorm,
  pointwise 1×1 convs as plain matmuls, LayerScale residual. Blocks are
  stacked on a leading depth axis and run under ``lax.scan``.
- **iSTFT head**: a linear layer predicts per-frame log-magnitude and
  phase; the inverse real DFT is ONE [2·n_freqs, n_fft] matmul (no FFT
  butterflies, and exact), followed by ``n_fft/hop`` strided overlap-adds.
  Whether cuDNN's depthwise conv or ``jnp.fft`` is faster on the GPU is not
  measured yet.

Everything is batched [B, N, …]; output is [B, N·hop] float32 waveform.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

Params = Dict[str, Any]

DW_KERNEL = 7
LAYERSCALE_INIT = 1e-6
LOG_MAG_CLIP = 10.0  # e**10 ≈ 22000 — safety clip before exp


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    dim: int = 512
    intermediate_dim: int = 1536
    num_layers: int = 8
    n_mels: int = 100
    n_fft: int = 1024
    hop_length: int = 256
    compute_dtype: Any = jnp.float32

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _as_rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def _dense(rng, fan_in: int, fan_out: int, *lead: int):
    std = 1.0 / np.sqrt(fan_in)
    return {
        "w": rng.normal(0.0, std, (*lead, fan_in, fan_out)).astype(np.float32),
        "b": np.zeros((*lead, fan_out), np.float32),
    }


def init_vocoder_params(seed, cfg: VocoderConfig) -> Params:
    """Random-init pytree (numpy float32); structure matches
    ``parallel/sharding.param_pspecs``."""
    rng = _as_rng(seed)
    d, inter, L, k = cfg.dim, cfg.intermediate_dim, cfg.num_layers, DW_KERNEL
    return {
        "embed": {
            # Conv1d(n_mels → dim, kernel 7) input embedding.
            "w": rng.normal(0.0, 1.0 / np.sqrt(k * cfg.n_mels), (k, cfg.n_mels, d)).astype(
                np.float32
            ),
            "b": np.zeros((d,), np.float32),
        },
        "norm_in_scale": np.ones((d,), np.float32),
        "norm_in_bias": np.zeros((d,), np.float32),
        "blocks": {
            "dwconv": {
                "w": rng.normal(0.0, 1.0 / np.sqrt(k), (L, k, 1, d)).astype(np.float32),
                "b": np.zeros((L, d), np.float32),
            },
            "pw1": _dense(rng, d, inter, L),
            "pw2": _dense(rng, inter, d, L),
            "gamma": np.full((L, d), LAYERSCALE_INIT, np.float32),
            "norm_scale": np.ones((L, d), np.float32),
            "norm_bias": np.zeros((L, d), np.float32),
        },
        "norm_out_scale": np.ones((d,), np.float32),
        "norm_out_bias": np.zeros((d,), np.float32),
        "head": _dense(rng, d, 2 * cfg.n_freqs),
    }


# ---------------------------------------------------------------------------
# Depthwise conv as shifted adds
# ---------------------------------------------------------------------------


def _dwconv(p: dict, x: jnp.ndarray) -> jnp.ndarray:
    """Depthwise SAME 1-D conv via k shifted adds; exact match for
    ``lax.conv_general_dilated(..., feature_group_count=C)`` with NWC/WIO
    layout and weight [k, 1, C].

    The k shifted element-wise multiply-adds fuse into the surrounding ops
    in XLA.
    """
    w, b = p["w"], p["b"]
    k = w.shape[0]
    n = x.shape[1]
    lo = (k - 1) // 2  # XLA SAME: pad_lo = floor((k-1)/2), pad_hi = ceil(...)
    xp = jnp.pad(x, ((0, 0), (lo, k - 1 - lo), (0, 0)))
    out = xp[:, 0:n, :] * w[0, 0]
    for j in range(1, k):
        out = out + xp[:, j : j + n, :] * w[j, 0]
    return out + b


def _layernorm_affine(x: jnp.ndarray, scale, bias) -> jnp.ndarray:
    x32 = x.astype(jnp.float32)
    mu = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mu), axis=-1, keepdims=True)
    return (x32 - mu) * jax.lax.rsqrt(var + 1e-6) * scale + bias


# ---------------------------------------------------------------------------
# iSTFT via iDFT matmul + strided overlap-add
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _idft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag inverse-rDFT bases, each [n_freqs, n_fft] float32.

    frame[t] = Σ_k w_k/n_fft · (Re_k·cos(2πkt/n) − Im_k·sin(2πkt/n)),
    w_k = 1 at DC and Nyquist, 2 elsewhere (conjugate-symmetric doubling).
    """
    n_freqs = n_fft // 2 + 1
    k = np.arange(n_freqs)[:, None]
    t = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    w = np.full((n_freqs, 1), 2.0)
    w[0] = 1.0
    w[-1] = 1.0
    cos_b = (w * np.cos(ang) / n_fft).astype(np.float32)
    sin_b = (-w * np.sin(ang) / n_fft).astype(np.float32)
    return cos_b, sin_b


@lru_cache(maxsize=8)
def _hann_periodic(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def istft_overlap_add(
    real: jnp.ndarray,  # [B, N, n_freqs]
    imag: jnp.ndarray,  # [B, N, n_freqs]
    n_fft: int,
    hop: int,
) -> jnp.ndarray:
    """Inverse STFT (centered, periodic Hann, NOLA-normalized) → [B, N·hop].

    Matches the forward convention the mel front-end uses
    (``ops/stft.py``): reflect-padded by n_fft/2, window applied on
    analysis; synthesis windows again and divides by the overlapped
    window-energy envelope.
    """
    if n_fft % hop != 0:
        raise ValueError(f"n_fft {n_fft} must be a multiple of hop {hop}")
    b, n, _ = real.shape
    cos_b, sin_b = _idft_basis(n_fft)
    win = jnp.asarray(_hann_periodic(n_fft))

    # One matmul per basis: [B, N, n_freqs] @ [n_freqs, n_fft].
    frames = real @ jnp.asarray(cos_b) + imag @ jnp.asarray(sin_b)
    frames = frames * win  # synthesis window

    r = n_fft // hop
    out_len = (n + r - 1) * hop
    buf = jnp.zeros((b, out_len), frames.dtype)
    env = np.zeros((out_len,), np.float64)
    win_np = _hann_periodic(n_fft).astype(np.float64)
    for j in range(r):
        # Within one phase j the hop-sized pieces tile contiguously, so the
        # whole phase is one strided add at static offset j·hop.
        seg = frames[:, :, j * hop : (j + 1) * hop].reshape(b, n * hop)
        buf = buf.at[:, j * hop : j * hop + n * hop].add(seg)
        # Window-energy envelope accumulated host-side (static shapes).
        env[j * hop : j * hop + n * hop] += np.tile(
            win_np[j * hop : (j + 1) * hop] ** 2, n
        )
    envelope = jnp.asarray(np.maximum(env, 1e-8).astype(np.float32))
    buf = buf / envelope
    pad = n_fft // 2
    return buf[:, pad : pad + n * hop]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed_conv(p: dict, x: jnp.ndarray) -> jnp.ndarray:
    """SAME dense 1-D conv (n_mels → dim), NWC/WIO."""
    return (
        jax.lax.conv_general_dilated(
            x,
            p["w"].astype(x.dtype),
            (1,),
            "SAME",
            dimension_numbers=("NWC", "WIO", "NWC"),
        )
        + p["b"].astype(x.dtype)
    )


def vocoder_forward(params: Params, cfg: VocoderConfig, mel: jnp.ndarray) -> jnp.ndarray:
    """Log-mel [B, N, n_mels] → waveform [B, N·hop] float32."""
    dtype = cfg.compute_dtype
    x = _embed_conv(params["embed"], mel.astype(jnp.float32))
    x = _layernorm_affine(x, params["norm_in_scale"], params["norm_in_bias"])

    def block(x, blk):
        h = _dwconv({"w": blk["dwconv"]["w"], "b": blk["dwconv"]["b"]}, x)
        h = _layernorm_affine(h, blk["norm_scale"], blk["norm_bias"]).astype(dtype)
        h = jax.nn.gelu(h @ blk["pw1"]["w"].astype(dtype) + blk["pw1"]["b"].astype(dtype))
        h = h @ blk["pw2"]["w"].astype(dtype) + blk["pw2"]["b"].astype(dtype)
        return x + blk["gamma"] * h.astype(jnp.float32), None

    x, _ = jax.lax.scan(block, x, params["blocks"])
    x = _layernorm_affine(x, params["norm_out_scale"], params["norm_out_bias"])

    h = x @ params["head"]["w"] + params["head"]["b"]  # [B, N, 2·n_freqs] f32
    log_mag, phase = jnp.split(h, 2, axis=-1)
    mag = jnp.exp(jnp.clip(log_mag, -LOG_MAG_CLIP, LOG_MAG_CLIP))
    real = mag * jnp.cos(phase)
    imag = mag * jnp.sin(phase)
    return istft_overlap_add(real, imag, cfg.n_fft, cfg.hop_length)
