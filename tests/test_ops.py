"""Numerical tests for the compute ops: mel front-end vs torch/scipy
reference, RoPE properties, attention vs naive implementation and the
choice of attention implementation, iSTFT round-trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vietvoice_tts_tpu.ops.attention import (
    CUDNN,
    PLAIN,
    attention,
    choose_attention,
    packed_rope_attention,
    prefix_lengths,
)
from vietvoice_tts_tpu.ops.rope import apply_rope, rope_tables
from vietvoice_tts_tpu.ops.stft import MelFrontend, mel_filterbank


class TestMelFrontend:
    def test_shapes(self):
        fe = MelFrontend(n_fft=256, win_length=256, hop_length=64, n_mels=20)
        wave = jnp.zeros((2, 64 * 32))
        mel = fe(wave)
        assert mel.shape == (2, 32, 20)

    def test_silence_is_log_floor(self):
        fe = MelFrontend(n_fft=256, win_length=256, hop_length=64, n_mels=20)
        mel = np.asarray(fe(jnp.zeros((1, 64 * 8))))
        # The +1e-12 magnitude epsilon leaks ~1e-6 per bin through wide mel
        # triangles, so allow a small band above the exact log floor.
        assert mel.max() <= np.log(1e-5) + 1.0
        assert mel.min() >= np.log(1e-5) - 1e-4

    def test_matches_torch_stft(self):
        """Golden test against torch.stft + HTK mel (the Vocos front-end)."""
        torch = pytest.importorskip("torch")
        sr, n_fft, hop, n_mels = 24000, 512, 128, 40
        rng = np.random.default_rng(0)
        wave = rng.uniform(-0.5, 0.5, hop * 16).astype(np.float32)

        fe = MelFrontend(sr, n_fft, n_fft, hop, n_mels)
        ours = np.asarray(fe(jnp.asarray(wave)[None]))[0]

        t = torch.stft(
            torch.from_numpy(wave),
            n_fft=n_fft,
            hop_length=hop,
            win_length=n_fft,
            window=torch.hann_window(n_fft, periodic=True),
            center=True,
            pad_mode="reflect",
            return_complex=True,
        )
        mag = t.abs().numpy()[:, : ours.shape[0]]  # [freq, frames]
        fb = mel_filterbank(sr, n_fft, n_mels)
        theirs = np.log(np.clip(mag.T @ fb, 1e-5, None))
        np.testing.assert_allclose(ours, theirs, atol=2e-3)

    def test_tone_hits_expected_mel_bin(self):
        sr, n_fft, hop, n_mels = 24000, 1024, 256, 100
        fe = MelFrontend(sr, n_fft, n_fft, hop, n_mels)
        t = np.arange(hop * 64) / sr
        tone = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
        mel = np.asarray(fe(jnp.asarray(tone)[None]))[0]
        peak_bin = mel[32].argmax()
        # 1 kHz on an HTK mel scale with 100 bins over 0-12 kHz: expect an
        # energy peak in the lower third of bins.
        assert 10 <= peak_bin <= 45


class TestRope:
    def test_norm_preserved(self):
        cos, sin = rope_tables(16, 8)
        q = jnp.ones((1, 2, 16, 8))
        out = apply_rope(q, cos, sin)
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(out), axis=-1),
            np.linalg.norm(np.asarray(q), axis=-1),
            rtol=1e-5,
        )

    def test_relative_property(self):
        """<rope(q,m), rope(k,n)> depends only on m-n."""
        d = 16
        cos, sin = rope_tables(32, d)
        rng = np.random.default_rng(1)
        q = jnp.asarray(rng.standard_normal((1, 1, 32, d)).astype(np.float32))
        k = jnp.asarray(rng.standard_normal((1, 1, 32, d)).astype(np.float32))
        qr = np.asarray(apply_rope(q, cos, sin))[0, 0]
        kr = np.asarray(apply_rope(k, cos, sin))[0, 0]
        # shift both positions by 5: use same vectors at shifted positions
        q2 = jnp.asarray(np.broadcast_to(np.asarray(q)[0, 0, 3], (1, 1, 32, d)))
        k2 = jnp.asarray(np.broadcast_to(np.asarray(k)[0, 0, 7], (1, 1, 32, d)))
        q2r = np.asarray(apply_rope(q2, cos, sin))[0, 0]
        k2r = np.asarray(apply_rope(k2, cos, sin))[0, 0]
        dot_a = q2r[3] @ k2r[7]
        dot_b = q2r[8] @ k2r[12]  # same offset of 4
        np.testing.assert_allclose(dot_a, dot_b, rtol=1e-4)

    def test_position_zero_identity(self):
        cos, sin = rope_tables(4, 8)
        q = jnp.asarray(np.random.default_rng(0).standard_normal((1, 1, 4, 8)))
        out = apply_rope(q, cos, sin)
        np.testing.assert_allclose(np.asarray(out)[0, 0, 0], np.asarray(q)[0, 0, 0], atol=1e-6)


class TestAttention:
    def test_matches_naive(self):
        rng = np.random.default_rng(0)
        q, k, v = (
            jnp.asarray(rng.standard_normal((2, 4, 16, 8)).astype(np.float32))
            for _ in range(3)
        )
        out = np.asarray(attention(q, k, v))
        logits = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8)
        w = np.exp(logits - logits.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        naive = np.einsum("bhqk,bhkd->bhqd", w, np.asarray(v))
        np.testing.assert_allclose(out, naive, atol=1e-5)

    def test_mask_blocks_padding(self):
        rng = np.random.default_rng(0)
        q, k, v = (
            jnp.asarray(rng.standard_normal((1, 2, 8, 4)).astype(np.float32))
            for _ in range(3)
        )
        mask = jnp.asarray(np.array([[True] * 4 + [False] * 4]))
        out = np.asarray(attention(q, k, v, mask))
        # Change padded keys/values: output over valid queries must not move.
        k2 = k.at[:, :, 4:].set(99.0)
        v2 = v.at[:, :, 4:].set(-99.0)
        out2 = np.asarray(attention(q, k2, v2, mask))
        np.testing.assert_allclose(out[:, :, :4], out2[:, :, :4], atol=1e-5)


class TestIstft:
    def test_roundtrip(self):
        """STFT → iSTFT reconstructs the original signal."""
        from vietvoice_tts_tpu.models.vocoder import istft_overlap_add

        n_fft, hop = 512, 128
        rng = np.random.default_rng(0)
        n_frames = 32
        wave = rng.uniform(-0.8, 0.8, n_frames * hop).astype(np.float32)
        # Forward STFT (matching layout): centered, reflect pad, Hann.
        pad = n_fft // 2
        x = np.pad(wave, pad, mode="reflect")
        win = np.hanning(n_fft + 1)[:-1]
        frames = np.stack(
            [x[i * hop : i * hop + n_fft] * win for i in range(n_frames)]
        )
        spec = np.fft.rfft(frames, axis=-1)
        out = istft_overlap_add(
            jnp.asarray(spec.real.astype(np.float32))[None],
            jnp.asarray(spec.imag.astype(np.float32))[None],
            n_fft,
            hop,
        )
        out = np.asarray(out)[0]
        # Edges lack full overlap; compare the interior.
        sl = slice(n_fft, len(wave) - n_fft)
        np.testing.assert_allclose(out[sl], wave[sl], atol=1e-4)


class TestDepthwiseConvRewrite:
    """The shifted-add depthwise conv must equal lax.conv exactly."""

    def test_matches_lax_conv(self):
        import jax
        from vietvoice_tts_tpu.models.vocoder import _dwconv

        rng = np.random.default_rng(0)
        c, k = 24, 7
        x = jnp.asarray(rng.standard_normal((2, 50, c)).astype(np.float32))
        p = {
            "w": jnp.asarray(rng.standard_normal((k, 1, c)).astype(np.float32)),
            "b": jnp.asarray(rng.standard_normal((c,)).astype(np.float32)),
        }
        ours = np.asarray(_dwconv(p, x))
        ref = np.asarray(
            jax.lax.conv_general_dilated(
                x, p["w"], (1,), "SAME",
                dimension_numbers=("NWC", "WIO", "NWC"),
                feature_group_count=c,
            )
            + p["b"]
        )
        np.testing.assert_allclose(ours, ref, atol=1e-5)

    def test_even_kernel(self):
        import jax
        from vietvoice_tts_tpu.models.vocoder import _dwconv

        rng = np.random.default_rng(1)
        c, k = 8, 4
        x = jnp.asarray(rng.standard_normal((1, 20, c)).astype(np.float32))
        p = {
            "w": jnp.asarray(rng.standard_normal((k, 1, c)).astype(np.float32)),
            "b": jnp.zeros((c,), jnp.float32),
        }
        ours = np.asarray(_dwconv(p, x))
        ref = np.asarray(
            jax.lax.conv_general_dilated(
                x, p["w"], (1,), "SAME",
                dimension_numbers=("NWC", "WIO", "NWC"),
                feature_group_count=c,
            )
        )
        np.testing.assert_allclose(ours, ref, atol=1e-5)


class TestChooseAttention:
    """One function picks the attention implementation from the platform,
    the compute dtype and the head width."""

    @pytest.mark.parametrize(
        "platform,dtype,head_dim,expected",
        [
            ("gpu", "bfloat16", 128, CUDNN),
            ("gpu", "bfloat16", 64, CUDNN),  # converted F5 layout, 16 × 64
            ("gpu", "float16", 128, CUDNN),
            ("gpu", "float32", 128, PLAIN),  # the f32 reference numerics
            ("gpu", "bfloat16", 100, PLAIN),  # not a multiple of 8
            ("gpu", "bfloat16", 256, PLAIN),  # wider than 128
            ("cpu", "bfloat16", 128, PLAIN),
            ("cpu", "float32", 64, PLAIN),
        ],
    )
    def test_table(self, platform, dtype, head_dim, expected):
        assert choose_attention(platform, jnp.dtype(dtype), head_dim) == expected


class TestPrefixLengths:
    def test_prefix_mask_to_lengths(self):
        mask = np.arange(8)[None, :] < np.array([8, 3, 0])[:, None]
        lengths = prefix_lengths(jnp.asarray(mask))
        assert lengths.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(lengths), [8, 3, 0])

    @pytest.mark.parametrize(
        "row", [[True, False, True, False], [False, True, True, True]]
    )
    def test_non_prefix_mask_refused(self, row):
        mask = np.array([[True] * 4, row])
        with pytest.raises(ValueError, match="prefix"):
            prefix_lengths(jnp.asarray(mask))

    def test_traced_mask_gives_lengths(self):
        mask = np.arange(6)[None, :] < np.array([6, 2])[:, None]
        out = jax.jit(prefix_lengths)(jnp.asarray(mask))
        np.testing.assert_array_equal(np.asarray(out), [6, 2])


def _moveaxis_reference(qkv, cos, sin, mask, heads):
    """Packed QKV → [B, H, N, D] views → RoPE → plain attention → packed."""
    B, N, three_hd = qkv.shape
    D = three_hd // (3 * heads)
    r = qkv.reshape(B, N, 3, heads, D)
    q, k, v = (jnp.moveaxis(jnp.asarray(r[:, :, i]), 1, 2) for i in range(3))
    out = attention(
        apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, jnp.asarray(mask)
    )
    return np.moveaxis(np.asarray(out), 1, 2).reshape(B, N, heads * D)


class TestPackedRopeAttention:
    """The packed-QKV wrapper the DiT calls, against the moveaxis
    reference, at the serving (8 × 128) and converted-F5 (16 × 64) head
    layouts, with padded rows."""

    @pytest.mark.parametrize("heads,head_dim", [(8, 128), (16, 64)])
    @pytest.mark.parametrize("n", [64, 768])
    def test_plain_matches_moveaxis_reference(self, heads, head_dim, n):
        rng = np.random.default_rng(n + heads)
        qkv = rng.standard_normal((2, n, 3 * heads * head_dim)).astype(np.float32)
        lengths = np.array([n, n - n // 3])
        mask = np.arange(n)[None, :] < lengths[:, None]
        cos, sin = rope_tables(n, head_dim)
        out = np.asarray(
            packed_rope_attention(
                jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
                jnp.asarray(mask), heads, PLAIN,
            )
        )
        ref = _moveaxis_reference(qkv, cos, sin, mask, heads)
        assert out.shape == (2, n, heads * head_dim)
        valid = mask[..., None]
        assert np.abs(np.where(valid, out - ref, 0.0)).max() < 1e-5

    def test_cudnn_call_contract(self, monkeypatch):
        """The cuDNN branch hands [B, N, H, D] views and per-row lengths to
        ``jax.nn.dot_product_attention``. cuDNN itself runs only on the GPU
        (``chip_smoke.py``), so the call is routed to JAX's own
        implementation with the same arguments."""
        real = jax.nn.dot_product_attention
        calls = []

        def fake(q, k, v, **kw):
            calls.append((q.shape, kw["implementation"]))
            return real(q, k, v, **{**kw, "implementation": "xla"})

        monkeypatch.setattr(jax.nn, "dot_product_attention", fake)
        heads, head_dim, n = 4, 64, 96
        rng = np.random.default_rng(3)
        qkv = rng.standard_normal((2, n, 3 * heads * head_dim)).astype(np.float32)
        mask = np.arange(n)[None, :] < np.array([n, 40])[:, None]
        cos, sin = rope_tables(n, head_dim)
        out = np.asarray(
            packed_rope_attention(
                jnp.asarray(qkv), jnp.asarray(cos), jnp.asarray(sin),
                jnp.asarray(mask), heads, CUDNN,
            )
        )
        assert calls == [((2, n, heads, head_dim), "cudnn")]
        ref = _moveaxis_reference(qkv, cos, sin, mask, heads)
        assert np.abs(np.where(mask[..., None], out - ref, 0.0)).max() < 1e-4

    def test_unknown_implementation_refused(self):
        qkv = jnp.zeros((1, 8, 3 * 2 * 8), jnp.float32)
        cos, sin = rope_tables(8, 8)
        with pytest.raises(ValueError, match="unknown attention"):
            packed_rope_attention(
                qkv, jnp.asarray(cos), jnp.asarray(sin),
                jnp.ones((1, 8), bool), 2, "pallas",
            )
