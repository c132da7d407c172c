"""Mel-spectrogram front-end as dense matmuls.

The reference computes reference-audio STFT→mel inside the opaque
``preprocess.onnx`` graph (run at
reference ``vietvoicetts/core/tts_engine.py:133-146``). Here framing
is a reshape plus shifted slices, then the windowed DFT is two matmuls
against precomputed cos/sin bases (win=1024 → a [F,1024]x[1024,513]
matmul), and the mel projection is a third matmul. Whether ``jnp.fft`` is
faster on the GPU is not measured yet. Everything is static-shape so one compiled
program serves each frame bucket.

Vocos-style parameters (F5-TTS family): power-1 magnitude, HTK mel scale,
no filterbank norm, natural-log compression clamped at 1e-5, reflect-padded
centered frames.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def hz_to_mel_htk(f: np.ndarray | float) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz_htk(m: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Triangular HTK-scale mel filterbank [n_freqs, n_mels], no norm."""
    fmax = fmax or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel_htk(fmin), hz_to_mel_htk(fmax), n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)
    fb = np.zeros((n_freqs, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def _dft_bases(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT cos/sin bases [win_length, n_fft//2+1]."""
    n_freqs = n_fft // 2 + 1
    window = np.hanning(win_length + 1)[:-1].astype(np.float64)  # periodic Hann
    t = np.arange(win_length)[:, None]  # [win, 1]
    k = np.arange(n_freqs)[None, :]  # [1, n_freqs]
    ang = 2.0 * np.pi * t * k / n_fft
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (-np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


class MelFrontend:
    """Log-mel extraction: waveform [B, T] → mel [B, frames, n_mels].

    ``T`` must equal ``frames * hop_length`` (callers pad the waveform to the
    frame bucket). Centered frames use reflect padding of ``n_fft // 2``.
    """

    def __init__(
        self,
        sample_rate: int = 24000,
        n_fft: int = 1024,
        win_length: int = 1024,
        hop_length: int = 256,
        n_mels: int = 100,
    ):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.n_mels = n_mels
        cos_b, sin_b = _dft_bases(n_fft, win_length)
        self.cos_basis = jnp.asarray(cos_b)
        self.sin_basis = jnp.asarray(sin_b)
        self.mel_fb = jnp.asarray(
            mel_filterbank(sample_rate, n_fft, n_mels)
        )

    @partial(jax.jit, static_argnums=0)
    def __call__(self, waveform: jnp.ndarray) -> jnp.ndarray:
        """waveform [B, T] float32 in [-1, 1] → log-mel [B, T//hop, n_mels]."""
        b, t = waveform.shape
        n_frames = t // self.hop_length
        pad = self.n_fft // 2
        x = jnp.pad(waveform, ((0, 0), (pad, pad)), mode="reflect")
        hop, win = self.hop_length, self.win_length
        if win % hop == 0 and pad % hop == 0:
            # win = P·hop ⇒ framing is a reshape + P shifted slices — no
            # gather of an [F, win] index grid.
            phases = win // hop
            blocks = x.reshape(b, -1, hop)  # [B, n_blocks, hop]
            frames = jnp.concatenate(
                [blocks[:, j : j + n_frames] for j in range(phases)], axis=-1
            )  # [B, F, win]
        else:
            starts = jnp.arange(n_frames) * hop
            idx = starts[:, None] + jnp.arange(win)[None, :]
            frames = x[:, idx]  # [B, F, win]
        # Windowed real DFT as two matmuls, f32 accumulation.
        re = jnp.einsum(
            "bfw,wk->bfk", frames, self.cos_basis, preferred_element_type=jnp.float32
        )
        im = jnp.einsum(
            "bfw,wk->bfk", frames, self.sin_basis, preferred_element_type=jnp.float32
        )
        mag = jnp.sqrt(re * re + im * im + 1e-12)
        mel = jnp.einsum(
            "bfk,km->bfm", mag, self.mel_fb, preferred_element_type=jnp.float32
        )
        return jnp.log(jnp.clip(mel, min=1e-5))
