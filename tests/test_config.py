"""ModelConfig tests — mirrors reference coverage
(``/root/reference/tests/test_model_config.py``): defaults, validation
ranges, dict round-trip, constants, plus the runtime additions (buckets,
derived properties)."""

import pytest

from vietvoice_tts_tpu.config import (
    MODEL_AREA,
    MODEL_EMOTION,
    MODEL_GENDER,
    MODEL_GROUP,
    ModelConfig,
    TTSConfig,
)


class TestDefaults:
    def test_reference_compatible_defaults(self):
        cfg = ModelConfig()
        assert cfg.nfe_step == 32
        assert cfg.fuse_nfe == 1
        assert cfg.sample_rate == 24000
        assert cfg.speed == 0.9
        assert cfg.random_seed == 9527
        assert cfg.hop_length == 256
        assert cfg.gender == "female"
        assert cfg.area == "northern"
        assert cfg.emotion == "neutral"
        assert cfg.group == "audiobook"
        assert cfg.pause_punctuation == r".,?!:"
        assert cfg.cross_fade_duration == 0.1
        assert cfg.max_chunk_duration == 20.0
        assert cfg.min_target_duration == 1.0

    def test_alias(self):
        assert TTSConfig is ModelConfig

    def test_constants(self):
        assert "male" in MODEL_GENDER and "female" in MODEL_GENDER
        assert len(MODEL_GROUP) == 5
        assert len(MODEL_AREA) == 3
        assert len(MODEL_EMOTION) == 7


class TestValidation:
    def test_speed_range(self):
        with pytest.raises(ValueError):
            ModelConfig(speed=0.05)
        with pytest.raises(ValueError):
            ModelConfig(speed=6.0)

    def test_nfe_range(self):
        with pytest.raises(ValueError):
            ModelConfig(nfe_step=0)
        with pytest.raises(ValueError):
            ModelConfig(nfe_step=101)

    def test_heads_divide_dim(self):
        with pytest.raises(ValueError):
            ModelConfig(dit_dim=100, dit_heads=16)

    def test_buckets_sorted(self):
        with pytest.raises(ValueError):
            ModelConfig(frame_buckets=(512, 256))


class TestDerived:
    def test_head_dim(self):
        # 8 heads × 128 (see config.py dit_heads note).
        assert ModelConfig().head_dim == 128

    def test_frame_bucket_for(self):
        cfg = ModelConfig(frame_buckets=(128, 512, 2048))
        assert cfg.frame_bucket_for(1) == 128
        assert cfg.frame_bucket_for(128) == 128
        assert cfg.frame_bucket_for(129) == 512
        assert cfg.frame_bucket_for(99999) == 2048  # clamps

    def test_model_path_is_under_cache(self):
        cfg = ModelConfig(model_cache_dir="/tmp/xyz", model_name="pack-a")
        assert cfg.model_path == "/tmp/xyz/pack-a"


class TestDictRoundTrip:
    def test_round_trip(self):
        cfg = ModelConfig(speed=1.2, nfe_step=16)
        d = cfg.to_dict()
        cfg2 = ModelConfig.from_dict(d)
        assert cfg2.speed == 1.2
        assert cfg2.nfe_step == 16
        assert cfg2.to_dict() == d

    def test_from_dict_drops_unknown_keys(self):
        cfg = ModelConfig.from_dict({"speed": 1.0, "bogus_key": 42})
        assert cfg.speed == 1.0


class TestReferenceAudioValidation:
    def test_valid_short_reference(self, sample_wav):
        cfg = ModelConfig()
        assert cfg.validate_with_reference_audio(sample_wav) is True

    def test_reference_too_long_for_chunk(self, sample_wav):
        cfg = ModelConfig(max_chunk_duration=1.5)
        assert cfg.validate_with_reference_audio(sample_wav) is False

    def test_missing_file_is_false(self):
        cfg = ModelConfig()
        assert cfg.validate_with_reference_audio("/nope.wav") is False


class TestLatencyBuckets:
    """Round-3: finer 384/768 buckets cut the latency path's padding waste
    (a ~350-frame short sentence pays 9% padding instead of 45%)."""

    def test_default_grid_contains_fine_buckets(self):
        cfg = ModelConfig()
        assert 384 in cfg.frame_buckets
        assert 768 in cfg.frame_buckets

    def test_typical_shapes_land_in_fine_buckets(self):
        cfg = ModelConfig()
        assert cfg.frame_bucket_for(352) == 384   # short sentence + default ref
        assert cfg.frame_bucket_for(452) == 512   # voice clone, 3 s ref
        assert cfg.frame_bucket_for(662) == 704   # voice clone, longer target
        assert cfg.frame_bucket_for(730) == 768
        assert cfg.frame_bucket_for(2600) == 2048  # clamps to max
