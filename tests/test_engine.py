"""End-to-end engine tests on the tiny CPU model: synthesis output contract,
chunk planning policy, determinism, voice selection."""

import numpy as np
import pytest

from vietvoice_tts_tpu.client import TTSApi
from vietvoice_tts_tpu.utils.wavio import read_wav


class TestSynthesize:
    def test_returns_int16_and_time(self, tiny_engine):
        wave, t = tiny_engine.synthesize("Xin chào.")
        assert wave.dtype == np.int16
        assert wave.size > 0
        assert t > 0

    def test_deterministic(self, tiny_engine):
        w1, _ = tiny_engine.synthesize("Một câu kiểm tra.")
        w2, _ = tiny_engine.synthesize("Một câu kiểm tra.")
        np.testing.assert_array_equal(w1, w2)

    def test_output_file(self, tiny_engine, temp_dir):
        path = f"{temp_dir}/out.wav"
        wave, _ = tiny_engine.synthesize("Ghi ra tệp.", output_path=path)
        samples, sr = read_wav(path)
        assert sr == tiny_engine.config.sample_rate
        assert samples.shape[0] == wave.size

    def test_voice_filters(self, tiny_engine):
        wave, _ = tiny_engine.synthesize("Giọng nữ.", gender="female", area="southern")
        assert wave.size > 0

    def test_invalid_gender_raises(self, tiny_engine):
        # select_sample runs before the wrapped try (as in the reference,
        # tts_engine.py:217-221), so the ValueError propagates directly.
        with pytest.raises(ValueError):
            tiny_engine.synthesize("x", gender="robot")

    def test_sample_iteration_out_of_range(self, tiny_engine):
        # Build filters that definitely match ≥1 catalog sample so the
        # iteration bound is actually checked (no-match falls back to
        # sample 0, as in the reference model.py:189-190).
        s = tiny_engine.model_session_manager.sample_metadata[0]
        with pytest.raises(ValueError):
            tiny_engine.model_session_manager.select_sample(
                gender=s["gender"],
                group=s["group"],
                area=s["area"],
                emotion=s["emotion"],
                sample_iteration=10_000,
            )

    def test_no_match_falls_back_to_first_sample(self, tiny_engine):
        mgr = tiny_engine.model_session_manager
        # Find a combo absent from the catalog (groups cycle, so most
        # (gender, area, emotion, group) tuples don't exist).
        existing = {(s["gender"], s["area"], s["emotion"], s["group"]) for s in mgr.sample_metadata}
        from vietvoice_tts_tpu.config import MODEL_AREA, MODEL_EMOTION, MODEL_GROUP

        for area in MODEL_AREA:
            for emo in MODEL_EMOTION:
                for grp in MODEL_GROUP:
                    if ("male", area, emo, grp) not in existing:
                        audio, text = mgr.select_sample(
                            gender="male", area=area, emotion=emo, group=grp
                        )
                        assert text == mgr.sample_metadata[0]["text"]
                        return
        pytest.skip("catalog covers all combos")

    def test_reference_audio_requires_text(self, tiny_engine, sample_wav):
        with pytest.raises((RuntimeError, ValueError)):
            tiny_engine.synthesize("x", reference_audio=sample_wav)

    def test_voice_clone_with_user_audio(self, tiny_engine, sample_wav):
        wave, _ = tiny_engine.synthesize(
            "Nhân bản giọng nói.",
            reference_audio=sample_wav,
            reference_text="Đây là giọng tham khảo.",
        )
        assert wave.size > 0

    def test_clone_conflicts_with_filters(self, tiny_engine, sample_wav):
        with pytest.raises((RuntimeError, ValueError)):
            tiny_engine.synthesize(
                "x",
                gender="male",
                reference_audio=sample_wav,
                reference_text="t",
            )


class TestChunkPlanning:
    def test_single_chunk_short_text(self, tiny_engine):
        ref = np.zeros(24000, np.float32)
        plans = tiny_engine._plan_chunks(ref, "Tham khảo.", "Câu ngắn.")
        assert len(plans) == 1
        assert plans[0].total_len <= plans[0].bucket

    def test_long_text_multi_chunk(self, tiny_engine):
        ref = np.zeros(24000, np.float32)
        long_text = " ".join(f"Câu số {i} trong đoạn văn dài." for i in range(60))
        plans = tiny_engine._plan_chunks(ref, "Tham khảo.", long_text)
        assert len(plans) > 1
        for p in plans:
            assert p.ref_len < p.total_len <= p.bucket

    def test_ref_longer_than_chunk_raises(self, tiny_pack_dir):
        from tests.conftest import tiny_config
        from vietvoice_tts_tpu.pipeline.engine import TTSEngine

        cfg = tiny_config(model_cache_dir=tiny_pack_dir, max_chunk_duration=1.5)
        engine = TTSEngine(cfg)
        ref = np.zeros(2 * 24000, np.float32)  # 2 s reference > 1.5 s cap
        long_text = " ".join(["nhiều chữ"] * 300)
        with pytest.raises(ValueError):
            engine._plan_chunks(ref, "Tham khảo.", long_text)


class TestClientApi:
    def test_lazy_engine(self, tiny_pack_dir):
        from tests.conftest import tiny_config

        api = TTSApi(tiny_config(model_cache_dir=tiny_pack_dir))
        assert api._engine is None
        _ = api.engine
        assert api._engine is not None
        api.cleanup()
        assert api._engine is None

    def test_none_text_raises(self, tiny_pack_dir):
        from tests.conftest import tiny_config

        api = TTSApi(tiny_config(model_cache_dir=tiny_pack_dir))
        with pytest.raises(ValueError):
            api.synthesize(None)

    def test_synthesize_to_bytes_is_wav(self, tiny_pack_dir):
        from tests.conftest import tiny_config

        api = TTSApi(tiny_config(model_cache_dir=tiny_pack_dir))
        data, t = api.synthesize_to_bytes("Một câu.")
        assert data[:4] == b"RIFF"
        samples, sr = read_wav(data)
        assert sr == 24000
        api.cleanup()

    def test_context_manager(self, tiny_pack_dir):
        from tests.conftest import tiny_config

        with TTSApi(tiny_config(model_cache_dir=tiny_pack_dir)) as api:
            wave, _ = api.synthesize("Ngữ cảnh.")
            assert wave.size > 0


class TestDiTProperties:
    def test_masked_frames_zero_velocity(self, tiny_engine):
        import jax.numpy as jnp

        from vietvoice_tts_tpu.models.dit import dit_forward

        core = tiny_engine.engine_core
        b, n, m = 1, 128, core.dit_cfg.n_mels
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal((b, n, m)).astype(np.float32))
        cond = jnp.zeros((b, n, m))
        text = jnp.full((b, n), -1, jnp.int32)
        t = jnp.asarray([0.5], jnp.float32)
        mask = jnp.asarray(np.arange(n)[None, :] < 64)
        v = np.asarray(
            dit_forward(core.params["dit"], core.dit_cfg, x, cond, text, t, mask)
        )
        assert np.abs(v[0, 64:]).max() == 0.0
        assert np.abs(v[0, :64]).max() > 0.0

    def test_batch_consistency(self, tiny_engine):
        """Row i of a batched call matches a single-row call (masking works)."""
        core = tiny_engine.engine_core
        hop = core.config.hop_length
        n = 128
        rng = np.random.default_rng(0)
        wave = rng.uniform(-0.5, 0.5, (2, n * hop)).astype(np.float32)
        wave[1] = wave[0]
        ref_len = np.array([16, 16], np.int32)
        total = np.array([96, 96], np.int32)
        text = np.full((2, n), -1, np.int32)
        text[:, :32] = 5
        out2 = core.synthesize_batch(wave, ref_len, text, total, seed=7)
        out1 = core.synthesize_batch(wave[:1], ref_len[:1], text[:1], total[:1], seed=7)
        # XLA may fuse differently per batch shape; allow 1 int16 LSB.
        np.testing.assert_allclose(
            out1[0].astype(np.int32), out2[0].astype(np.int32), atol=1
        )

    def test_async_matches_sync(self, tiny_engine):
        """synthesize_batch_async returns the same int16 audio as the
        blocking path (same program, deferred fetch)."""
        core = tiny_engine.engine_core
        hop = core.config.hop_length
        n = 128
        rng = np.random.default_rng(1)
        wave = rng.uniform(-0.5, 0.5, (2, n * hop)).astype(np.float32)
        ref_len = np.array([16, 16], np.int32)
        total = np.array([96, 128], np.int32)
        text = np.full((2, n), -1, np.int32)
        text[:, :32] = 5
        fetch = core.synthesize_batch_async(wave, ref_len, text, total, seed=3)
        sync = core.synthesize_batch(wave, ref_len, text, total, seed=3)
        out = fetch()
        assert out.dtype == np.int16
        np.testing.assert_array_equal(out, sync)

    def test_int16_packing_is_pcm_exact(self, tiny_engine):
        """The device-side int16 conversion equals host-side
        (clip(x)*32767).astype(int16) of the float pipeline output."""
        import jax
        import jax.numpy as jnp

        core = tiny_engine.engine_core
        hop = core.config.hop_length
        n = 128
        rng = np.random.default_rng(2)
        wave = rng.uniform(-0.5, 0.5, (1, n * hop)).astype(np.float32)
        ref_len = np.array([16], np.int32)
        total = np.array([128], np.int32)
        text = np.full((1, n), 5, np.int32)

        packed = core.synthesize_batch(wave, ref_len, text, total, seed=0)

        # Re-run the identical program but stop before the int16 packing.
        from vietvoice_tts_tpu.models.sampler import flow_matching_sample
        from vietvoice_tts_tpu.models.vocoder import vocoder_forward

        def float_pipeline(params, w, rl, ti, tl, seeds):
            mel = core.frontend(w.astype(jnp.float32))
            frame_idx = jnp.arange(n, dtype=jnp.int32)
            is_ref = frame_idx[None, :] < rl[:, None]
            mask = frame_idx[None, :] < tl[:, None]
            cond = jnp.where(is_ref[..., None], mel, 0.0)
            key = jax.random.PRNGKey(core.config.random_seed)
            latent = flow_matching_sample(
                params["dit"], core.dit_cfg, core.sampler_cfg, key, cond, ti,
                mask, seeds,
            )
            latent = jnp.where(is_ref[..., None], mel, latent)
            latent = jnp.where(mask[..., None], latent, 0.0)
            return vocoder_forward(params["vocoder"], core.voc_cfg, latent)

        f32 = np.asarray(
            jax.jit(float_pipeline)(
                core.params,
                jnp.asarray(wave, jnp.float16),
                jnp.asarray(ref_len),
                jnp.asarray(text),
                jnp.asarray(total),
                jnp.zeros((1,), jnp.uint32),
            )
        )
        expect = (np.clip(f32, -1.0, 1.0) * 32767.0).astype(np.int16)
        np.testing.assert_array_equal(packed, expect)


class TestSamplerGrid:
    def test_nfe_semantics_match_reference(self):
        """nfe_step=32 must mean 31 velocity evaluations (reference loop is
        ``range(0, nfe_step-1, fuse_nfe)``, core/tts_engine.py:157)."""
        from vietvoice_tts_tpu.models.sampler import SamplerConfig, sway_time_grid

        cfg = SamplerConfig(nfe_step=32)
        grid = np.asarray(sway_time_grid(cfg))
        assert grid.shape == (32,)  # 31 intervals
        assert grid[0] == 0.0 and abs(grid[-1] - 1.0) < 1e-6
        assert np.all(np.diff(grid) > 0)

    def test_nfe_one_is_identity(self):
        from vietvoice_tts_tpu.models.sampler import SamplerConfig, sway_time_grid

        grid = np.asarray(sway_time_grid(SamplerConfig(nfe_step=1)))
        assert grid.shape == (1,)  # zero integration steps


class TestWarmupGrid:
    def test_warmup_covers_batcher_padding(self, tiny_engine):
        """warmup() must compile exactly the padded batch shapes the
        micro-batcher dispatches, so batch 2 never hits a cold compile."""
        from vietvoice_tts_tpu.config import batch_grid

        tiny_engine.warmup(buckets=(128,))
        cached = set(tiny_engine.engine_core._jit_cache)
        # The serving path is the cached-conditioning program (the waveform
        # variant only compiles on cache-ineligible fallback).
        for b in batch_grid(tiny_engine.config.max_batch_size):
            assert (b, 128, True) in cached, f"batch {b} not warmed: {cached}"


class TestBatchGridHelpers:
    def test_grid_powers_of_two_capped(self):
        from vietvoice_tts_tpu.config import batch_grid, pad_batch_size

        assert batch_grid(8) == (1, 2, 3, 4, 6, 8)
        assert batch_grid(6) == (1, 2, 3, 4, 6)
        assert batch_grid(1) == (1,)
        assert pad_batch_size(3, 8) == 3
        assert pad_batch_size(5, 8) == 6  # midpoint: 75% worst-case rows
        assert pad_batch_size(5, 6) == 6
        assert pad_batch_size(7, 6) == 6  # clamps, never exceeds max


class TestStreamingSynthesis:
    """Chunk-by-chunk streaming (beyond-reference): concatenated stream
    output must equal the batch synthesize() waveform."""

    LONG = " ".join(f"Câu số {i} trong đoạn văn dài." for i in range(60))

    def test_stream_equals_batch_multichunk(self, tiny_engine):
        batch_wave, _ = tiny_engine.synthesize(self.LONG)
        pieces = list(tiny_engine.synthesize_streaming(self.LONG))
        assert len(pieces) >= 2  # actually streamed in multiple pieces
        np.testing.assert_array_equal(np.concatenate(pieces), batch_wave)

    def test_stream_single_chunk(self, tiny_engine):
        batch_wave, _ = tiny_engine.synthesize("Một câu ngắn.")
        pieces = list(tiny_engine.synthesize_streaming("Một câu ngắn."))
        np.testing.assert_array_equal(np.concatenate(pieces), batch_wave)

    def test_stream_through_batcher(self, tiny_engine):
        batch_wave, _ = tiny_engine.synthesize(self.LONG)
        tiny_engine.enable_micro_batching(max_wait_ms=5)
        try:
            pieces = list(tiny_engine.synthesize_streaming(self.LONG))
            np.testing.assert_array_equal(np.concatenate(pieces), batch_wave)
        finally:
            tiny_engine.batcher.shutdown()
            tiny_engine.batcher = None

    def test_client_passthrough(self, tiny_pack_dir):
        from tests.conftest import tiny_config
        from vietvoice_tts_tpu.client import TTSApi

        with TTSApi(tiny_config(model_cache_dir=tiny_pack_dir)) as api:
            pieces = list(api.synthesize_streaming("Xin chào."))
            assert pieces and all(p.dtype == np.int16 for p in pieces)

    def test_first_chunk_cap_shortens_first_piece(self, tiny_engine):
        """first_chunk_duration caps the head chunk so playback starts
        sooner on long texts (TTFA = one chunk's latency). The stream stops byte-matching
        the blocking output (different chunking) but stays valid audio of
        the same total scale."""
        eng = tiny_engine
        ref_audio, ref_text = eng.model_session_manager.select_sample()
        ref_f32 = eng._load_ref(ref_audio).astype(np.float32) / 32768.0
        base_plans = eng._plan_chunks(ref_f32, ref_text, self.LONG)
        # Cap at half the base head chunk's target duration so the policy
        # must engage regardless of the tiny config's chunk sizes.
        sr, hop = eng.config.sample_rate, eng.config.hop_length
        ref_frames = base_plans[0].ref_len
        head_target_s = (base_plans[0].total_len - ref_frames) * hop / sr
        cap = head_target_s / 2
        cap_plans = eng._plan_chunks(
            ref_f32, ref_text, self.LONG, first_chunk_cap=cap
        )
        assert len(cap_plans) > len(base_plans)
        assert (cap_plans[0].total_len - cap_plans[0].ref_len) < (
            base_plans[0].total_len - base_plans[0].ref_len
        )
        # End-to-end: the capped stream is valid audio of the same scale.
        base = list(eng.synthesize_streaming(self.LONG))
        capped = list(
            eng.synthesize_streaming(self.LONG, first_chunk_duration=cap)
        )
        assert len(capped) > len(base)
        total_base = sum(len(p) for p in base)
        total_capped = sum(len(p) for p in capped)
        assert 0.7 < total_capped / total_base < 1.3
        assert all(p.dtype == np.int16 for p in capped)

    def test_default_cap_off_preserves_equality(self, tiny_engine):
        """With the cap unset the stream≡batch guarantee must hold — the
        cap is strictly opt-in."""
        assert tiny_engine.config.streaming_first_chunk_duration is None
        batch_wave, _ = tiny_engine.synthesize(self.LONG)
        pieces = list(tiny_engine.synthesize_streaming(self.LONG))
        np.testing.assert_array_equal(np.concatenate(pieces), batch_wave)


class TestStreamCrossfadeMath:
    def test_matches_batch_concatenation(self):
        from vietvoice_tts_tpu.pipeline.audio import AudioProcessor

        rng = np.random.default_rng(0)
        chunks = [
            (rng.uniform(-0.6, 0.6, n) * 32767).astype(np.int16)
            for n in (24000, 30000, 26000)
        ]
        batch = AudioProcessor.concatenate_with_crossfade_improved(
            [c.copy() for c in chunks], 0.1, 24000
        )
        stream = np.concatenate(
            list(AudioProcessor.stream_with_crossfade(iter(chunks), 0.1, 24000))
        )
        np.testing.assert_array_equal(stream, batch)

    def test_zero_fade_is_plain_concat(self):
        from vietvoice_tts_tpu.pipeline.audio import AudioProcessor

        chunks = [np.full(100, i * 1000, np.int16) for i in range(3)]
        out = np.concatenate(
            list(AudioProcessor.stream_with_crossfade(iter(chunks), 0.0, 24000))
        )
        np.testing.assert_array_equal(out, np.concatenate(chunks))
