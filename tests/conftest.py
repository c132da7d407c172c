"""Test configuration: the tests run on the CPU, with 8 virtual devices
for the mesh tests.

Must run before any JAX backend initialization. ``jax.config.update`` pins
the platform even where a GPU is visible; what only the GPU can run is a
phase of ``chip_smoke.py``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import tempfile

import numpy as np
import pytest

from vietvoice_tts_tpu.config import ModelConfig


def tiny_config(**overrides) -> ModelConfig:
    """Small dims + small buckets so CPU tests compile in seconds."""
    defaults = dict(
        dit_dim=64,
        dit_depth=2,
        dit_heads=4,
        text_dim=32,
        text_conv_layers=1,
        vocoder_dim=64,
        vocoder_intermediate_dim=128,
        vocoder_num_layers=2,
        nfe_step=4,
        frame_buckets=(128, 256),
        max_batch_size=4,
        compute_dtype="float32",
    )
    defaults.update(overrides)
    return ModelConfig(**defaults)


@pytest.fixture(scope="session")
def tiny_pack_dir():
    """Session-scoped weight pack so the materialize cost is paid once."""
    with tempfile.TemporaryDirectory() as td:
        cfg = tiny_config(model_cache_dir=td)
        from vietvoice_tts_tpu.runtime.session import ModelSessionManager

        mgr = ModelSessionManager(cfg)
        mgr.load_models()
        yield td


@pytest.fixture(scope="session")
def tiny_engine(tiny_pack_dir):
    from vietvoice_tts_tpu.pipeline.engine import TTSEngine

    cfg = tiny_config(model_cache_dir=tiny_pack_dir)
    engine = TTSEngine(cfg)
    yield engine
    engine.cleanup()


@pytest.fixture
def temp_dir():
    with tempfile.TemporaryDirectory() as td:
        yield td


@pytest.fixture
def sample_wav(temp_dir):
    """A deterministic 1-second 24 kHz test tone on disk."""
    from vietvoice_tts_tpu.utils.wavio import write_wav

    t = np.arange(24000) / 24000.0
    tone = (0.5 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)
    path = os.path.join(temp_dir, "tone.wav")
    write_wav(tone, path, 24000)
    return path
