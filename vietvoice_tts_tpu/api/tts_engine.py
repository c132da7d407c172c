"""Async engine wrapper for the REST API.

Counterpart of ``/root/reference/vietvoicetts/api/tts_engine.py:11-101``:
a lazily-initialized process-wide ``TTSApi`` singleton, with the blocking
synthesis call moved off the event loop via ``asyncio.to_thread``. Two
deliberate fixes over the reference:

- speed is passed as a per-request argument instead of mutating the shared
  config around the call (the reference documents this race at
  ``api/tts_engine.py:64-69``);
- duration is computed from the decoded sample count, not from byte length.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..client import TTSApi
from ..config import ModelConfig
from ..utils.logging import get_logger
from .schemas import Area, Emotion, Gender, Group

log = get_logger("api.engine")

_engine: Optional[TTSApi] = None
# Server-side default: refuse synthetic packs unless VIETVOICE_ALLOW_SYNTHETIC
# opts in (api/settings.py) — a server quietly producing random-weight noise
# with HTTP 200 is worse than one that fails to start.
from .settings import settings as _settings  # noqa: E402

_engine_config = ModelConfig(allow_synthetic_pack=_settings.ALLOW_SYNTHETIC)


def get_tts_engine() -> TTSApi:
    """Lazily-initialized singleton (model loads on first request)."""
    global _engine
    if _engine is None:
        log.info("Initializing TTS engine for the first time...")
        try:
            _engine = TTSApi(_engine_config)
        except Exception as e:  # noqa: BLE001 — startup boundary
            log.error("Fatal error during TTS engine initialization: %s", e)
            raise RuntimeError(f"Could not initialize TTS Engine: {e}") from e
        log.info("TTS engine initialized successfully.")
    return _engine


def reset_engine() -> None:
    """Drop the singleton (used by tests and reload)."""
    global _engine
    if _engine is not None:
        _engine.cleanup()
    _engine = None


async def synthesize_async(
    text: str,
    speed: float,
    gender: Gender | None,
    group: Group | None,
    area: Area | None,
    emotion: Emotion | None,
    sample_iteration: int | None,
) -> tuple[bytes, int, float]:
    """Synthesize on a worker thread → (wav_bytes, sample_rate, duration_s)."""
    try:
        engine = get_tts_engine()
        gender_value = gender.value if gender else _engine_config.gender
        group_value = group.value if group else _engine_config.group
        area_value = area.value if area else _engine_config.area
        emotion_value = emotion.value if emotion else _engine_config.emotion

        def _call():
            return engine.synthesize_to_bytes(
                text,
                gender=gender_value,
                group=group_value,
                area=area_value,
                emotion=emotion_value,
                sample_iteration=sample_iteration,
                speed=speed,
            )

        audio_bytes, _gen_time = await asyncio.to_thread(_call)
        sample_rate = engine.config.sample_rate
        # 16-bit PCM mono with a 44-byte header.
        duration_seconds = max(len(audio_bytes) - 44, 0) / (sample_rate * 2)
        return audio_bytes, sample_rate, duration_seconds
    except Exception as e:  # noqa: BLE001 — handler converts to 500
        log.error("Error during synthesis: %s", e)
        raise


async def synthesize_stream_async(
    text: str,
    speed: float,
    gender: Gender | None,
    group: Group | None,
    area: Area | None,
    emotion: Emotion | None,
    sample_iteration: int | None,
    first_chunk_duration: float | None = None,
):
    """Async byte stream: a streaming-WAV header, then PCM pieces as each
    chunk finishes on the device. Each blocking ``next()`` on the underlying
    generator runs on a worker thread, so the event loop serves other
    requests between pieces (beyond-reference capability)."""
    from ..utils.wavio import wav_stream_header

    engine = get_tts_engine()
    gen = engine.synthesize_streaming(
        text,
        gender=gender.value if gender else _engine_config.gender,
        group=group.value if group else _engine_config.group,
        area=area.value if area else _engine_config.area,
        emotion=emotion.value if emotion else _engine_config.emotion,
        sample_iteration=sample_iteration,
        speed=speed,
        first_chunk_duration=first_chunk_duration,
    )
    yield wav_stream_header(engine.config.sample_rate)
    sentinel = object()
    while True:
        try:
            piece = await asyncio.to_thread(next, gen, sentinel)
        except Exception as e:  # noqa: BLE001 — mid-stream failure
            log.error("Error during streaming synthesis: %s", e)
            raise
        if piece is sentinel:
            break
        yield piece.astype("<i2").tobytes()
