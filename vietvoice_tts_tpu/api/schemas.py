"""Pydantic request/response schemas.

Field-for-field parity with the reference
(``/root/reference/vietvoicetts/api/schemas.py:6-81``): voice enums, health
response, synthesize request (text 1–1000 chars, speed 0.25–2.0 default 0.9,
output_format "wav", optional voice filters, sample_iteration ≥ 0), and the
file-synthesis response.
"""

from __future__ import annotations

from enum import Enum
from typing import Literal, Optional

from pydantic import BaseModel, Field


class Gender(str, Enum):
    MALE = "male"
    FEMALE = "female"


class Group(str, Enum):
    STORY = "story"
    NEWS = "news"
    AUDIOBOOK = "audiobook"
    INTERVIEW = "interview"
    REVIEW = "review"


class Area(str, Enum):
    NORTHERN = "northern"
    SOUTHERN = "southern"
    CENTRAL = "central"


class Emotion(str, Enum):
    NEUTRAL = "neutral"
    SERIOUS = "serious"
    MONOTONE = "monotone"
    SAD = "sad"
    SURPRISED = "surprised"
    HAPPY = "happy"
    ANGRY = "angry"


class HealthResponse(BaseModel):
    """Health check payload.

    Superset of the reference's (status, uptime) — adds accelerator
    visibility so load balancers can detect a wedged device, which the
    reference's uptime-only check cannot (SURVEY §5: health endpoint is
    uptime-only, api/app.py:37-41).
    """

    status: Literal["healthy", "degraded"]
    uptime: int = Field(..., description="Uptime of the server in seconds.")
    backend: Optional[str] = Field(None, description="JAX backend (gpu/cpu).")
    device_count: Optional[int] = Field(None, description="Visible devices.")
    engine_loaded: Optional[bool] = Field(
        None, description="Whether the model is resident in memory."
    )
    batcher_healthy: Optional[bool] = Field(
        None,
        description=(
            "Micro-batcher worker-thread liveness. A dead thread is "
            "restarted by the health check itself (self-healing); the check "
            "that found it dead reports status=degraded. None when the "
            "batcher is not enabled."
        ),
    )
    last_error: Optional[str] = Field(
        None, description="Most recent batch-dispatch error, if any."
    )
    synthetic_weights: Optional[bool] = Field(
        None,
        description=(
            "True when the loaded weight pack was materialized from a seed "
            "(random weights — audio is noise, not speech). None until the "
            "engine loads."
        ),
    )


class StatsResponse(BaseModel):
    """Serving statistics: per-stage device time and batcher efficiency."""

    stage_seconds: dict = Field(default_factory=dict)
    batcher: Optional[dict] = Field(None)
    cond_cache: Optional[dict] = Field(None)
    hbm: Optional[dict] = Field(None)


class SynthesizeRequest(BaseModel):
    """Request body for speech synthesis."""

    text: str = Field(
        ...,
        min_length=1,
        max_length=1000,
        description="The text to be synthesized into speech.",
    )
    speed: float = Field(
        0.9, ge=0.25, le=2.0, description="Speech speed. 0.9 is normal speed."
    )
    output_format: Literal["wav"] = Field("wav", description="Output audio format.")
    gender: Optional[Gender] = Field(None, description="Filter voice by gender.")
    group: Optional[Group] = Field(None, description="Filter voice by group/style.")
    area: Optional[Area] = Field(None, description="Filter voice by regional accent.")
    emotion: Optional[Emotion] = Field(None, description="Filter voice by emotion.")
    sample_iteration: Optional[int] = Field(
        None,
        ge=0,
        description=(
            "Choose which iteration of available samples to use (0-based). "
            "First available sample when unset."
        ),
    )


class StreamSynthesizeRequest(SynthesizeRequest):
    """Request body for the chunked streaming route — adds the opt-in
    time-to-first-audio knob (beyond-reference)."""

    first_chunk_duration: Optional[float] = Field(
        None,
        gt=0,
        le=20,
        description=(
            "Cap the FIRST chunk's target audio length (seconds) so "
            "playback starts sooner on long texts. Adds one cross-fade "
            "boundary near the start; the "
            "stream then no longer byte-matches the blocking output."
        ),
    )


class VoiceEntry(BaseModel):
    """One catalog voice (beyond-reference: the reference only documents
    the four enums; the bundled 239-row catalog is browsable over HTTP)."""

    filename: str
    gender: str
    group: str
    area: str
    emotion: str
    text: str = Field(..., description="Reference transcript of the clip.")
    clip_available: bool = Field(
        ..., description="Whether the audio clip exists in the local pack "
        "(clips ship with the weight tarball; the CSV catalog is bundled)."
    )


class VoicesResponse(BaseModel):
    """Catalog listing with the applied filters echoed back."""

    total: int
    filters: dict = Field(default_factory=dict)
    voices: list[VoiceEntry] = Field(default_factory=list)


class SynthesizeFileResponse(BaseModel):
    """Response for synthesis-to-file requests."""

    download_url: str = Field(..., description="URL to download the audio file.")
    duration_seconds: float = Field(..., description="Audio duration in seconds.")
    sample_rate: int = Field(..., description="Sample rate in Hz.")
    format: str = Field(..., description="Audio format.")
    file_size_bytes: int = Field(..., description="File size in bytes.")
