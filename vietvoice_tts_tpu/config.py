"""Configuration for the VietVoice TTS framework.

Mirrors the behavioral surface of the reference's ``ModelConfig``
(``/root/reference/vietvoicetts/core/model_config.py:22-153``): same defaults
(nfe_step=32, speed=0.9, seed=9527, sample_rate=24000, hop_length=256, voice
defaults, pause punctuation, chunking limits), same validation ranges, same
``from_dict``/``to_dict`` round-trip and the ``TTSConfig`` alias — but extends
it with the architecture/runtime knobs that replace ONNX session options:
model dims, dtype policy, shape buckets, mesh axes, and a local weight store
instead of an ONNX tarball download.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

# Voice metadata constants — same taxonomy as the reference
# (/root/reference/vietvoicetts/core/model_config.py:15-18).
MODEL_GENDER = ["male", "female"]
MODEL_GROUP = ["story", "news", "audiobook", "interview", "review"]
MODEL_AREA = ["northern", "southern", "central"]
MODEL_EMOTION = ["neutral", "serious", "monotone", "sad", "surprised", "happy", "angry"]

DETERMINISTIC_SEED = 9527


@dataclass
class ModelConfig:
    """Config for TTS inference."""

    # ---- Sampling / synthesis settings (reference-compatible) ----
    nfe_step: int = 32
    fuse_nfe: int = 1
    # CFG-cache acceleration (training-free, opt-in, beyond-reference): the
    # unconditional branch of classifier-free guidance drifts slowly along
    # the ODE path, so refresh it only every k-th velocity eval and reuse
    # the cached uncond velocity in between. 1 = exact (reference parity);
    # 2 cuts DiT compute ~25%. Quality impact must be judged on real
    # weights — keep 1 until then.
    nfe_uncond_interval: int = 1
    # Deep-block-cache acceleration (training-free, opt-in, TeaCache/Δ-DiT
    # family): every r-th velocity eval runs all DiT blocks and records the
    # deep trunk's residual contribution; the evals in between run only the
    # first ``nfe_deep_cache_blocks`` blocks and reuse it (the deep
    # residual drifts slowly between adjacent flow times). 1 = exact.
    # Speed on the GPU not measured. Mutually exclusive with
    # nfe_uncond_interval > 1; price on real weights (golden.py
    # --deep-cache-sweep) and enable at most one.
    nfe_deep_cache_interval: int = 1
    nfe_deep_cache_blocks: int = 7
    sample_rate: int = 24000
    speed: float = 0.9
    random_seed: int = DETERMINISTIC_SEED
    hop_length: int = 256
    cfg_strength: float = 2.0
    sway_sampling_coef: float = -1.0

    # ---- Sample selection defaults (reference model_config.py:37-40) ----
    gender: Optional[str] = "female"
    area: Optional[str] = "northern"
    emotion: Optional[str] = "neutral"
    group: Optional[str] = "audiobook"

    # ---- Text processing ----
    pause_punctuation: str = r".,?!:"

    # ---- Audio / chunking (reference model_config.py:46-48) ----
    cross_fade_duration: float = 0.1
    max_chunk_duration: float = 20.0
    min_target_duration: float = 1.0
    # Streaming-only first-chunk duration cap (seconds of target audio).
    # Time-to-first-audio for a long text is one chunk's latency; capping
    # the FIRST chunk short starts playback sooner, at the cost of one extra
    # cross-fade boundary near the start and one more dispatch. None (default) keeps the stream
    # byte-identical to blocking synthesize() — the guarantee tests pin;
    # per-call override via synthesize_streaming(first_chunk_duration=…).
    streaming_first_chunk_duration: Optional[float] = None

    # ---- Mel front-end (Vocos-style, F5-TTS family) ----
    n_mels: int = 100
    n_fft: int = 1024
    win_length: int = 1024

    # ---- DiT architecture ----
    dit_dim: int = 1024
    dit_depth: int = 22
    # 8 heads × head_dim 128. A converted F5 pack is 16 × 64
    # (models/probe.py reads the head count from the graph).
    dit_heads: int = 8
    dit_ff_mult: int = 2
    text_dim: int = 512
    text_conv_layers: int = 4
    vocab_size: int = 256  # overridden by the vocab file at load time

    # ---- Vocoder (ConvNeXt + iSTFT head) ----
    vocoder_dim: int = 512
    vocoder_intermediate_dim: int = 1536
    vocoder_num_layers: int = 8

    # ---- Runtime policy (replaces ORT session options,
    #      reference model_config.py:51-55) ----
    compute_dtype: str = "bfloat16"  # matmul/activation dtype inside the DiT
    # LayerNorm statistics dtype inside the DiT blocks. float32 (default)
    # matches the numerics-gate posture; "bfloat16" skips the norm upcast
    # traffic at extra serving drift — enable only after real-weight
    # quality review (same policy as nfe_uncond_interval).
    norm_dtype: str = "float32"
    param_dtype: str = "float32"  # master parameter dtype on HBM
    # Static mel-frame buckets: every chunk is padded up to one of these so
    # XLA compiles a bounded set of programs (no dynamic shapes).
    # The fine 64-multiple steps through the latency band (384–768) bound
    # padding waste at ≤17% where single requests land (a short sentence is
    # ~350–450 frames, a voice-clone request ~450–700) — at batch 1 the DiT
    # step cost scales almost linearly with the bucket, so padding waste is
    # latency waste. Above 768 traffic is batched long-text chunks where
    # per-row padding amortizes. Each bucket is one more XLA compile per
    # batch size — amortized by the persistent compile cache.
    # 440 and 544 are latency-band fillers taken from the planner: the
    # default-voice short sentence plans to 439 frames (188 ref + 251
    # target) and a 3 s voice-clone request to ~534 — without them those
    # land in 448/576 and pay 2-8% pure padding compute at batch 1. The
    # trimmed-fetch grid (32-frame, runtime/engine_core.pick_trim) is
    # independent of the buckets.
    frame_buckets: tuple[int, ...] = (
        256, 384, 440, 448, 512, 544, 576, 640, 704, 768, 1024, 2048
    )
    max_batch_size: int = 8
    donate_sampler_state: bool = True
    jax_compilation_cache_dir: Optional[str] = None
    # Host→device dtype for the reference waveform. float16 halves the bytes
    # sent at ~1e-3 amplitude quantization of the *reference* audio only
    # (synthesis output is unaffected); float32 gives bit-exact
    # conditioning.
    transfer_dtype: str = "float16"
    # Device-resident voice-conditioning cache: the reference waveform's
    # log-mel depends only on the voice, not the request, so cache it on the
    # device keyed by the audio bytes and stop re-sending the waveform on
    # every request — the wave H2D is the largest transfer of the chunk
    # program. Misses pay one frontend
    # dispatch per new voice; hits send only text ids and lengths.
    voice_cond_cache: bool = True
    voice_cond_cache_size: int = 64  # LRU entries (~400 KB HBM each)
    voice_cond_frames: int = 1024  # cached mel length cap (frames)
    # Batch sizes for which warmup() compiles trimmed-fetch program variants
    # (the D2H-saving programs that skip the discarded reference prefix).
    # (1,) = latency path only; widen to e.g. (1, 2, 4) when batched catalog
    # traffic shares the default voice and the extra warmup compiles pay
    # for themselves (every entry multiplies warmup compile count).
    trim_warm_batches: tuple[int, ...] = (1,)
    # Serve only packs converted from real weights: when False, loading a
    # pack whose model_meta.json carries "synthetic": true raises instead of
    # serving random-weight noise with HTTP 200.
    allow_synthetic_pack: bool = True

    # ---- Mesh / parallelism ----
    mesh_data_axis: int = 1  # utterance/chunk batch parallelism
    mesh_model_axis: int = 1  # tensor parallelism for DiT + vocoder
    # Spend the model axis on the mel-frame (sequence) dimension instead of
    # tensor parallelism: activations shard [B, N/sp, ...], attention runs
    # Ulysses/ring across the devices, params replicate over the axis. Pays off when
    # per-chip activation memory (long buckets) binds before weight memory.
    sequence_parallel: bool = False

    # ---- Weight store (replaces the ONNX tarball download,
    #      reference model_config.py:26-28,71-104) ----
    model_cache_dir: str = field(
        default_factory=lambda: os.environ.get("VIETVOICE_TPU_CACHE", "models")
    )
    model_name: str = "vietvoice-tpu-v1"
    # Optional path to the reference's ONNX tarball for weight conversion /
    # numerics golden tests; unused when absent.
    onnx_model_path: Optional[str] = None
    # URL the tarball is fetched from when ensure_model_downloaded() runs
    # (reference model_config.py:26). Unlike the reference, construction
    # NEVER touches the network — conversion is an explicit step here.
    model_url: Optional[str] = None

    def __post_init__(self) -> None:
        # Same validation ranges as the reference (model_config.py:57-63).
        if not 0.1 <= self.speed <= 5.0:
            raise ValueError("Speed must be between 0.1 and 5.0")
        if not 1 <= self.nfe_step <= 100:
            raise ValueError("NFE step must be between 1 and 100")
        if not 1 <= self.nfe_uncond_interval <= 8:
            raise ValueError("nfe_uncond_interval must be between 1 and 8")
        if not 1 <= self.nfe_deep_cache_interval <= 8:
            raise ValueError("nfe_deep_cache_interval must be between 1 and 8")
        if self.nfe_uncond_interval > 1 and self.nfe_deep_cache_interval > 1:
            raise ValueError(
                "nfe_uncond_interval and nfe_deep_cache_interval are "
                "mutually exclusive — enable at most one cache"
            )
        # blocks only matters when the cache is on — tiny test configs with
        # dit_depth < the full-size default of 7 stay constructible.
        if self.nfe_deep_cache_interval > 1 and not (
            1 <= self.nfe_deep_cache_blocks < self.dit_depth
        ):
            raise ValueError(
                "nfe_deep_cache_blocks must be in [1, dit_depth)"
            )
        if self.dit_dim % self.dit_heads != 0:
            raise ValueError("dit_dim must be divisible by dit_heads")
        if self.n_fft % self.hop_length != 0:
            raise ValueError("n_fft must be a multiple of hop_length")
        if tuple(self.frame_buckets) != tuple(sorted(self.frame_buckets)):
            raise ValueError("frame_buckets must be sorted ascending")
        if self.transfer_dtype not in ("float16", "float32", "bfloat16"):
            raise ValueError("transfer_dtype must be float16, float32, or bfloat16")

    # -- Derived properties --------------------------------------------------

    @property
    def head_dim(self) -> int:
        return self.dit_dim // self.dit_heads

    @property
    def model_path(self) -> str:
        """Directory holding the converted/initialized weight pack."""
        return str(Path(self.model_cache_dir).expanduser() / self.model_name)

    @property
    def max_frames(self) -> int:
        return self.frame_buckets[-1]

    def frame_bucket_for(self, n_frames: int) -> int:
        """Smallest static bucket that fits ``n_frames`` (clamps to max)."""
        for b in self.frame_buckets:
            if n_frames <= b:
                return b
        return self.frame_buckets[-1]

    def batch_grid(self) -> tuple[int, ...]:
        """Padded batch sizes actually dispatched to the device (see module
        function :func:`batch_grid`)."""
        return batch_grid(self.max_batch_size)

    def ensure_model_downloaded(self) -> str:
        """Fetch the reference ONNX tarball into the cache; return its path.

        Parity with ``reference model_config.py:71-104`` (progress logging,
        cache reuse) plus atomic staging and HTTP-Range resume
        (``models/download.py``). Unlike the reference this is NEVER called
        implicitly — zero-egress environments construct configs freely;
        conversion day calls it (or the download CLI) explicitly. Sets
        ``onnx_model_path`` to the fetched tarball."""
        from .models.download import DEFAULT_MODEL_URL, ensure_model_downloaded

        if self.onnx_model_path and Path(self.onnx_model_path).exists():
            return self.onnx_model_path
        path = ensure_model_downloaded(
            url=self.model_url or DEFAULT_MODEL_URL,
            dest=Path(self.model_cache_dir).expanduser() / "model-bin.pt",
        )
        self.onnx_model_path = str(path)
        return self.onnx_model_path

    # -- Validation against a reference audio file ---------------------------

    def validate_with_reference_audio(self, reference_audio_path: str) -> bool:
        """Check that a reference clip leaves room for ``min_target_duration``
        inside ``max_chunk_duration`` (reference model_config.py:114-141)."""
        from .utils.logging import get_logger
        from .utils.wavio import read_wav

        log = get_logger("config")
        try:
            samples, sr = read_wav(reference_audio_path)
            ref_duration = samples.shape[0] / float(sr)
            safety_margin = 1.0
            required = ref_duration + safety_margin + self.min_target_duration
            if self.max_chunk_duration < required:
                log.error(
                    "Configuration error: reference audio %.1fs needs "
                    "max_chunk_duration > %.1fs (current %.1fs)",
                    ref_duration,
                    required,
                    self.max_chunk_duration,
                )
                return False
            log.info(
                "Configuration valid: reference %.1fs, max chunk %.1fs, "
                "available target %.1fs",
                ref_duration,
                self.max_chunk_duration,
                self.max_chunk_duration - ref_duration - safety_margin,
            )
            return True
        except Exception as exc:  # noqa: BLE001 — mirror reference behavior
            log.error("Error validating reference audio: %s", exc)
            return False

    # -- Dict round-trip (reference model_config.py:143-153) -----------------

    @classmethod
    def from_dict(cls, config_dict: dict) -> "ModelConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config_dict.items() if k in known})

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = tuple(v) if isinstance(v, (list, tuple)) else v
        return out


# Backward-compatibility alias, as in the reference (model_config.py:157).
TTSConfig = ModelConfig


def batch_grid(max_batch: int) -> tuple[int, ...]:
    """Padded batch sizes actually dispatched to the device: powers of two up
    to ``max_batch``, their 3·2^k midpoints (3, 6, 12, …), and ``max_batch``
    itself (never exceeding it). The micro-batcher pads every dispatch up to
    a grid element and warmup compiles exactly this grid, so no request-time
    batch shape hits a cold compile.

    The midpoints matter at serving saturation: padded rows burn real device
    compute, and a pure power-of-two ladder caps worst-case row efficiency
    at ~50% (5 jobs → batch 8). With midpoints the worst case is ~75%
    (e.g. a mean batch of 5.42 padded to 8 — 68%
    row efficiency — with the 3/6 steps it pads to 6)."""
    grid = {g for g in (1 << i for i in range(max_batch.bit_length())) if g <= max_batch}
    grid |= {3 * g for g in grid if 3 * g <= max_batch}
    grid.add(max_batch)
    return tuple(sorted(grid))


def pad_batch_size(b: int, max_batch: int) -> int:
    """Smallest batch-grid element ≥ b (clamps to ``max_batch``)."""
    for g in batch_grid(max_batch):
        if b <= g:
            return g
    return max_batch
