"""The jitted synthesis core and its compiled-program cache.

This replaces the reference's three ORT sessions + Python NFE loop (reference ``vietvoicetts/core/tts_engine.py:133-187``): one
XLA program per (batch, frame-bucket) fuses the entire chunk pipeline —

    waveform → log-mel cond → scan(NFE × CFG-doubled DiT) → vocoder → waveform

so a chunk costs exactly one host→device→host round trip. The cache keyed by
static shapes plays the role of ORT's session map (``core/model.py:104``),
bounded because all inputs are padded into config-declared buckets.
"""

from __future__ import annotations

import hashlib
import os
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from ..models.dit import DiTConfig
from ..models.sampler import SamplerConfig, flow_matching_sample
from ..models.vocoder import VocoderConfig, vocoder_forward
from ..ops.stft import MelFrontend
from ..utils.logging import StageTimer, get_logger

log = get_logger("engine_core")


# Default persistent-compile-cache directory: inside the checkout, and listed
# in .gitignore.
DEFAULT_COMPILE_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(config: ModelConfig, environ=os.environ) -> Optional[str]:
    """The directory this program points JAX's compile cache at, or None.

    None when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that variable
    itself, and no other directory is set in code. Otherwise the config's
    ``jax_compilation_cache_dir`` when given, else ``<checkout>/.jax_cache``."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return config.jax_compilation_cache_dir or str(DEFAULT_COMPILE_CACHE_DIR)


def _enable_persistent_compile_cache(config: ModelConfig) -> None:
    """Keep compiled chunk programs on disk, so that each (batch, bucket)
    shape compiles once per cache directory."""
    cache_dir = compile_cache_dir(config)
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)


class EngineCore:
    """Owns device parameters, model configs, and the jit cache."""

    def __init__(self, config: ModelConfig, params, vocab_size: int, mesh=None):
        self.config = config
        _enable_persistent_compile_cache(config)
        self.vocab_size = vocab_size
        self.mesh = mesh
        self.dit_cfg = DiTConfig(
            dim=config.dit_dim,
            depth=config.dit_depth,
            heads=config.dit_heads,
            ff_mult=config.dit_ff_mult,
            n_mels=config.n_mels,
            text_dim=config.text_dim,
            text_conv_layers=config.text_conv_layers,
            vocab_size=vocab_size,
            compute_dtype=jnp.dtype(config.compute_dtype),
            norm_dtype=jnp.dtype(config.norm_dtype),
        )
        if mesh is not None and config.sequence_parallel:
            import dataclasses

            from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

            # The model axis is spent on frames: attention goes through
            # sp_attention (shard_map) and params replicate over the axis
            # (see _place_params).
            self.dit_cfg = dataclasses.replace(
                self.dit_cfg,
                seq_mesh=mesh,
                seq_axis=MODEL_AXIS,
                seq_batch_axis=DATA_AXIS,
            )
        self.voc_cfg = VocoderConfig(
            dim=config.vocoder_dim,
            intermediate_dim=config.vocoder_intermediate_dim,
            num_layers=config.vocoder_num_layers,
            n_mels=config.n_mels,
            n_fft=config.n_fft,
            hop_length=config.hop_length,
            compute_dtype=jnp.dtype(config.compute_dtype),
        )
        self.sampler_cfg = SamplerConfig(
            nfe_step=config.nfe_step,
            fuse_nfe=config.fuse_nfe,
            cfg_strength=config.cfg_strength,
            sway_sampling_coef=config.sway_sampling_coef,
            uncond_interval=config.nfe_uncond_interval,
            deep_cache_interval=config.nfe_deep_cache_interval,
            deep_cache_blocks=config.nfe_deep_cache_blocks,
        )
        self.frontend = MelFrontend(
            sample_rate=config.sample_rate,
            n_fft=config.n_fft,
            win_length=config.win_length,
            hop_length=config.hop_length,
            n_mels=config.n_mels,
        )
        self.params = self._place_params(params)
        # Reference-waveform H2D dtype (config.transfer_dtype): f16 halves
        # the bytes sent; f32 for bit-exact conditioning.
        self.transfer_dtype = jnp.dtype(config.transfer_dtype)
        self._jit_cache: Dict[Tuple, callable] = {}
        self.timer = StageTimer()
        # Device-resident voice-conditioning cache: sha1(ref audio bytes) →
        # [R_cap, n_mels] f32 log-mel on device. See _cond_handles.
        self._cond_cache: OrderedDict[str, jax.Array] = OrderedDict()
        self.cond_cache_hits = 0
        self.cond_cache_misses = 0
        # Warmed trim classes per (batch, n_frames, cond_cached) — see
        # pick_trim. Only warmup() adds entries.
        self._warm_trims: Dict[Tuple, set] = {}
        # Batch sizes for which warmup() compiles trimmed-fetch variants.
        # Batch 1 is the latency path; widen (e.g. {1, 2, 4, 8}) when batched
        # catalog traffic shares a voice and the extra compiles pay for
        # themselves.
        self._trim_batches = set(config.trim_warm_batches)

    # -- Parameter placement -------------------------------------------------

    # Leaves whose enclosing module is pure matmul work; placing them
    # directly in compute_dtype removes an f32→bf16 convert pass over the
    # weights on every step (the forward casts with .astype(compute_dtype)
    # at every use). "ada"/"final_ada" (the AdaLN-Zero modulation
    # projections) are matmul weights too: the ada stack is 553 MB in f32
    # (1024×6144 × 22 blocks), read on every solve. The product t_emb @ ada
    # still accumulates f32 (t_emb stays f32), so only the stored weights
    # are rounded; norm/scale math stays f32.
    _MATMUL_KEYS = frozenset(
        {"qkv", "attn_out", "ff1", "ff2", "input_proj", "pw1", "pw2",
         "conv_pos", "ada", "final_ada"}
    )

    def _inference_dtype_policy(self, params):
        """Cast matmul weights to compute_dtype; keep norm/ada/head f32."""
        dtype = self.dit_cfg.compute_dtype
        if dtype == jnp.float32:
            return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)

        def cast(path, x):
            keys = {
                p.key for p in path if isinstance(p, jax.tree_util.DictKey)
            }
            if keys & self._MATMUL_KEYS:
                return jnp.asarray(x, dtype)
            return jnp.asarray(x, jnp.float32)

        return jax.tree_util.tree_map_with_path(cast, params)

    def _place_params(self, params):
        """Put params on device; shard over the mesh when one is active.

        Under sequence parallelism the model axis carries frames, not
        tensor shards — params replicate over the whole mesh instead of the
        Megatron TP layout (the two are mutually exclusive per axis)."""
        if self.mesh is not None and self.config.sequence_parallel:
            from jax.sharding import NamedSharding, PartitionSpec

            repl = NamedSharding(self.mesh, PartitionSpec())
            return jax.tree.map(
                lambda x: jax.device_put(x, repl),
                self._inference_dtype_policy(params),
            )
        if self.mesh is not None:
            from ..parallel.sharding import shard_params

            return shard_params(params, self.mesh, self.dit_cfg, self.voc_cfg)
        return jax.device_put(self._inference_dtype_policy(params))

    # -- The fused chunk program --------------------------------------------

    def _sample_latent(
        self, params, mel, ref_len, text_ids, total_len, row_seeds, x0, n_frames
    ):
        """Shared trace from a [B, N, n_mels] log-mel: masks → sampled latent.

        Returns (mel, is_ref, mask, raw_latent). mel rows at or beyond
        ``ref_len`` are never read (masked by ``is_ref`` everywhere), so both
        the waveform path and the cached-conditioning path feed this."""
        frame_idx = jnp.arange(n_frames, dtype=jnp.int32)
        is_ref = frame_idx[None, :] < ref_len[:, None]
        mask = frame_idx[None, :] < total_len[:, None]
        cond = jnp.where(is_ref[..., None], mel, 0.0)
        key = jax.random.PRNGKey(self.config.random_seed)
        latent = flow_matching_sample(
            params["dit"], self.dit_cfg, self.sampler_cfg, key, cond, text_ids,
            mask, row_seeds, x0=x0,
        )
        return mel, is_ref, mask, latent

    def _latent_pipeline(
        self, params, wave, ref_len, text_ids, total_len, row_seeds, x0, n_frames
    ):
        """Waveform → mel cond/masks → sampled latent (golden-harness entry:
        the mel-latent program measures exactly the serving computation)."""
        mel = self.frontend(wave.astype(jnp.float32))  # [B, N, n_mels]
        return self._sample_latent(
            params, mel, ref_len, text_ids, total_len, row_seeds, x0, n_frames
        )

    def _finish_waveform(self, params, mel, is_ref, mask, latent, trim: int):
        """Latent → packed int16 PCM (shared tail of every chunk program).

        ``trim`` (static) drops that many leading frames from the packed
        output INSIDE the program: callers discard the reference prefix
        anyway, so those bytes need not reach the host. Slicing inside the
        program avoids a second dispatch after the chunk program."""
        # Keep the reference prefix at its ground-truth mel for the
        # vocoder's receptive field, zero out padding frames.
        latent = jnp.where(is_ref[..., None], mel, latent)
        latent = jnp.where(mask[..., None], latent, 0.0)
        wav = vocoder_forward(params["vocoder"], self.voc_cfg, latent)
        # PCM-exact int16 on device (same trunc semantics as
        # ``(x*32767).astype(np.int16)`` in the reference's
        # normalize path), packed as int32 pairs and viewed back as int16
        # on the host.
        pcm = (jnp.clip(wav, -1.0, 1.0) * 32767.0).astype(jnp.int16)
        b = pcm.shape[0]
        packed = jax.lax.bitcast_convert_type(
            pcm.reshape(b, -1, 2), jnp.int32
        )  # [B, n_frames*hop/2] i32
        if trim:
            packed = packed[:, trim * self.config.hop_length // 2 :]
        return packed

    def _build_chunk_fn(self, batch: int, n_frames: int, trim: int = 0):
        """Compile the full chunk pipeline for static (batch, n_frames)."""

        def chunk_fn(params, wave, ref_len, text_ids, total_len, row_seeds):
            # wave: [B, n_frames*hop] f16; ref_len/total_len: [B] i32;
            # text_ids: [B, n_frames] i32 (-1 padded); row_seeds: [B] u32.
            mel, is_ref, mask, latent = self._latent_pipeline(
                params, wave, ref_len, text_ids, total_len, row_seeds, None,
                n_frames,
            )
            return self._finish_waveform(params, mel, is_ref, mask, latent, trim)

        # Committed input shardings (params TP-sharded, batch data-sharded)
        # propagate through GSPMD — no per-program annotation needed.
        return jax.jit(chunk_fn)

    def _build_chunk_fn_cond(self, batch: int, n_frames: int, trim: int = 0):
        """Chunk pipeline fed by cached device-resident conditioning mels.

        Takes the B cached [R_cap, n_mels] mel arrays as trailing positional
        args (stacked inside the program — no separate stack dispatch, and
        rows sharing a voice pass the same device buffer), so the only
        host→device payload is text ids + lengths + seeds: the waveform —
        the chunk program's largest transfer — is not sent again."""

        def chunk_fn(params, ref_len, text_ids, total_len, row_seeds, *conds):
            mel_ref = jnp.stack(conds)  # [B, R_cap, n_mels] f32
            r = mel_ref.shape[1]
            if r < n_frames:
                mel = jnp.pad(mel_ref, ((0, 0), (0, n_frames - r), (0, 0)))
            else:
                mel = mel_ref[:, :n_frames]
            mel, is_ref, mask, latent = self._sample_latent(
                params, mel, ref_len, text_ids, total_len, row_seeds, None,
                n_frames,
            )
            return self._finish_waveform(params, mel, is_ref, mask, latent, trim)

        return jax.jit(chunk_fn)

    def chunk_fn(
        self, batch: int, n_frames: int, cond_cached: bool = False, trim: int = 0
    ):
        key = (batch, n_frames, cond_cached, trim) if trim else (
            batch, n_frames, cond_cached
        )
        if key not in self._jit_cache:
            t0 = time.perf_counter()
            build = self._build_chunk_fn_cond if cond_cached else self._build_chunk_fn
            self._jit_cache[key] = build(batch, n_frames, trim)
            log.debug(
                "Built chunk program for B=%d N=%d cond_cached=%s trim=%d in %.2fs",
                batch,
                n_frames,
                cond_cached,
                trim,
                time.perf_counter() - t0,
            )
        return self._jit_cache[key]

    # -- Trimmed-fetch program registry --------------------------------------

    def _cond_eligible(self, ref_len: np.ndarray, n_frames: int) -> bool:
        """Whether a batch can run the cached-conditioning program."""
        cfg = self.config
        if self.mesh is not None or not cfg.voice_cond_cache:
            return False
        margin = -(-cfg.n_fft // cfg.hop_length)  # 4 frames at 1024/256
        return not (ref_len + margin > min(self._cond_cap_frames, n_frames)).any()

    def pick_trim(self, batch: int, n_frames: int, ref_len: np.ndarray) -> int:
        """Largest WARMED trim class ≤ every row's ref_len (32-frame grid).

        Trim variants are full chunk-program compiles (minutes on a small
        host), so requests only ever use classes that warmup() registered —
        an unwarmed combination degrades to trim 0 (full fetch), never to a
        surprise compile."""
        if self.mesh is not None:
            return 0
        ref_len = np.asarray(ref_len, np.int32)
        want = int(ref_len.min()) // 32 * 32
        if want <= 0:
            return 0
        cond = self._cond_eligible(ref_len, n_frames)
        avail = self._warm_trims.get((batch, n_frames, cond), ())
        return max((t for t in avail if t <= want), default=0)

    # -- Voice-conditioning cache -------------------------------------------

    @property
    def _cond_cap_frames(self) -> int:
        return min(self.config.voice_cond_frames, self.config.frame_buckets[-1])

    def _cond_fn(self):
        """Jitted reference-mel extractor at the cache cap length."""
        key = ("cond_frontend", self._cond_cap_frames)
        if key not in self._jit_cache:

            def cond_fn(wave):  # [1, R_cap*hop] transfer dtype
                return self.frontend(wave.astype(jnp.float32))  # [1, R_cap, M] f32

            self._jit_cache[key] = jax.jit(cond_fn)
        return self._jit_cache[key]

    def _cond_handles(self, wave: np.ndarray, ref_len: np.ndarray, n_frames: int):
        """Device mel handles for each row's reference prefix, or None.

        The reference prefix's log-mel depends only on the first
        ``(ref_len+4)·hop`` waveform samples (centered STFT, reflect pad of
        2 hops — rows ≥ ref_len are masked out downstream), so it is cached
        on device keyed by those bytes. Returns None (→ waveform path) when
        the cache is disabled, a mesh is active (shardings differ), or any
        reference is too long for the cache window."""
        cfg = self.config
        if not self._cond_eligible(ref_len, n_frames):
            return None
        r_cap = self._cond_cap_frames
        margin = -(-cfg.n_fft // cfg.hop_length)  # 4 frames at 1024/256
        hop = cfg.hop_length
        handles = []
        for i in range(wave.shape[0]):
            used = np.ascontiguousarray(wave[i, : (int(ref_len[i]) + margin) * hop])
            key = hashlib.sha1(used.tobytes()).hexdigest()
            h = self._cond_cache.get(key)
            if h is None:
                self.cond_cache_misses += 1
                w = np.zeros((1, r_cap * hop), self.transfer_dtype)
                w[0, : used.shape[0]] = used
                h = self._cond_fn()(w)[0]  # [R_cap, n_mels] f32, on device
                self._cond_cache[key] = h
                while len(self._cond_cache) > cfg.voice_cond_cache_size:
                    self._cond_cache.popitem(last=False)
            else:
                self.cond_cache_hits += 1
                self._cond_cache.move_to_end(key)
            handles.append(h)
        return handles

    # -- Device→host fetch ----------------------------------------------------

    @staticmethod
    def _fetch(out) -> np.ndarray:
        """device_get with the copy request issued ASYNC first.

        Issuing ``copy_to_host_async`` before the blocking read queues the
        transfer behind the in-flight compute, so it starts as soon as the
        program ends."""
        try:
            out.copy_to_host_async()
        except Exception:  # pragma: no cover — sharded/backend variations
            pass
        return np.asarray(out)

    # -- Public batch API ----------------------------------------------------

    def synthesize_batch(
        self,
        wave: np.ndarray,  # [B, N*hop] float32 in [-1, 1]
        ref_len: np.ndarray,  # [B] int32 (frames)
        text_ids: np.ndarray,  # [B, N] int32, -1 padded
        total_len: np.ndarray,  # [B] int32 (frames, incl. reference)
        seed: int | np.ndarray = 0,
        trim_ref_frames: int = 0,
    ) -> np.ndarray:
        """Run one padded batch; returns [B, (N−trim)*hop] int16 waveforms.

        ``seed`` may be a scalar (applied to every row) or a [B] array of
        per-utterance seeds; per-row noise derivation makes each row's output
        independent of batch composition.

        ``trim_ref_frames`` (≤ every row's ref_len, 32-frame grid) makes the
        program drop that many leading frames before the fetch: callers
        discard the reference prefix anyway, so those bytes need not reach
        the host. Row i's audio then starts at frame
        ``trim_ref_frames``. Callers should pass ``pick_trim(...)`` so only
        warmed trim classes are used.
        """
        b = wave.shape[0]
        fn, args = self._prepare_dispatch(
            wave, ref_len, text_ids, total_len, seed, trim_ref_frames
        )
        with self.timer.stage("chunk_pipeline"):
            packed = self._fetch(fn(self.params, *args))
        return packed.view(np.int16).reshape(b, -1)

    def _prepare_dispatch(self, wave, ref_len, text_ids, total_len, seed, trim=0):
        """Resolve the chunk program + argument tuple for one padded batch.

        Prefers the cached-conditioning program (no waveform transfer) and
        falls back to the waveform program when the cache can't serve the
        batch (disabled, mesh active, or reference too long)."""
        b = wave.shape[0]
        n_frames = wave.shape[1] // self.config.hop_length
        row_seeds = np.broadcast_to(np.asarray(seed, np.uint32), (b,)).copy()
        ref_len = np.asarray(ref_len, np.int32)
        if trim:
            if self.mesh is not None:
                raise ValueError("trim_ref_frames is not supported under a mesh")
            if trim % 32 or (ref_len < trim).any():
                raise ValueError(
                    f"trim_ref_frames={trim} must be a 32-multiple "
                    f"≤ every row's ref_len"
                )
        small = (
            np.asarray(text_ids, np.int32),
            np.asarray(total_len, np.int32),
            row_seeds,
        )
        handles = self._cond_handles(np.asarray(wave, np.float32), ref_len, n_frames)
        if handles is not None:
            fn = self.chunk_fn(b, n_frames, cond_cached=True, trim=trim)
            return fn, (ref_len, *small, *handles)
        fn = self.chunk_fn(b, n_frames, trim=trim)
        # Numpy args go straight into the jit call: one dispatch moves all
        # five arrays instead of five explicit (latency-bound) transfers.
        args = (np.asarray(wave, self.transfer_dtype), ref_len, *small)
        if self.mesh is not None:
            from ..parallel.sharding import shard_batch

            args = shard_batch(self.mesh, *args)
        return fn, args

    def synthesize_batch_async(
        self,
        wave: np.ndarray,
        ref_len: np.ndarray,
        text_ids: np.ndarray,
        total_len: np.ndarray,
        seed: int | np.ndarray = 0,
        trim_ref_frames: int = 0,
    ):
        """Dispatch one padded batch without blocking.

        JAX dispatch is asynchronous: the returned thunk owns the in-flight
        device computation, and calling it fetches + unpacks the result.
        The serving batcher uses this to overlap the host↔device transfers
        and host work of batch k with the device compute of batch k+1.
        """
        b = wave.shape[0]
        fn, args = self._prepare_dispatch(
            wave, ref_len, text_ids, total_len, seed, trim_ref_frames
        )
        out = fn(self.params, *args)  # in flight
        try:
            out.copy_to_host_async()  # transfer request rides with compute
        except Exception:  # pragma: no cover
            pass

        def fetch() -> np.ndarray:
            with self.timer.stage("chunk_fetch"):
                packed = np.asarray(out)
            return packed.view(np.int16).reshape(b, -1)

        return fetch

    def mel_latent_batch(
        self,
        wave: np.ndarray,  # [B, N*hop] float32 in [-1, 1]
        ref_len: np.ndarray,  # [B] int32 (frames)
        text_ids: np.ndarray,  # [B, N] int32, -1 padded
        total_len: np.ndarray,  # [B] int32 (frames, incl. reference)
        seed: int | np.ndarray = 0,
        x0: np.ndarray | None = None,  # [B, N, n_mels] external noise
    ) -> np.ndarray:
        """Run the pipeline up to the sampled mel latent (no vocoder).

        This is the golden-numerics entry (BASELINE gate: mel allclose
        atol 1e-2 vs the ONNX reference): ``x0`` injects the reference
        preprocess graph's noise tensor so both systems integrate the same
        ODE initial condition. Returns the raw sampler output, [B, N,
        n_mels] float32, zeroed outside the valid mask (reference-prefix
        frames are NOT substituted with ground-truth mel here — the
        comparison wants the model's own output everywhere)."""
        b = wave.shape[0]
        n_frames = wave.shape[1] // self.config.hop_length
        row_seeds = np.broadcast_to(np.asarray(seed, np.uint32), (b,)).copy()
        key = ("latent", b, n_frames, x0 is not None)
        if key not in self._jit_cache:
            with_x0 = x0 is not None

            def latent_fn(params, wave, ref_len, text_ids, total_len, row_seeds, *rest):
                _mel, _is_ref, mask, latent = self._latent_pipeline(
                    params, wave, ref_len, text_ids, total_len, row_seeds,
                    rest[0] if with_x0 else None, n_frames,
                )
                return jnp.where(mask[..., None], latent, 0.0)

            self._jit_cache[key] = jax.jit(latent_fn)
        args = [
            np.asarray(wave, self.transfer_dtype),
            np.asarray(ref_len, np.int32),
            np.asarray(text_ids, np.int32),
            np.asarray(total_len, np.int32),
            row_seeds,
        ]
        if x0 is not None:
            args.append(np.asarray(x0, np.float32))
        if self.mesh is not None:
            from ..parallel.sharding import shard_batch

            args = shard_batch(self.mesh, *args)
        with self.timer.stage("mel_latent"):
            return self._fetch(self._jit_cache[key](self.params, *args))

    def warmup(
        self, batches=(1,), buckets=None, trim_classes=(0,), fallback_batches=(1,)
    ) -> None:
        """Ahead-of-time compile the configured shape buckets.

        ``trim_classes`` additionally compiles trimmed-fetch program
        variants (32-frame grid) — the latency path — and registers them
        with pick_trim. The engine derives the useful class from the default
        catalog voice's reference length; anything not registered here simply
        runs untrimmed.

        ``fallback_batches`` bounds which batch sizes ALSO pre-compile the
        non-cond-cached waveform fallback (the program a request falls back
        to when its reference exceeds the cond-cache window). Compiling it
        for every warm shape roughly doubles warmup time; the fallback only
        matters on the latency path (batch 1 — batched catalog traffic
        shares the default voice, which fits the window), so that is the
        default. Other shapes compile lazily on first use, amortized by the
        persistent XLA disk cache."""
        buckets = buckets or self.config.frame_buckets
        hop = self.config.hop_length
        for b in batches:
            for n in buckets:
                for trim in sorted(set(trim_classes)):
                    if trim and (trim % 32 or trim + 16 >= n):
                        continue
                    if trim and b not in self._trim_batches:
                        continue
                    ref = max(8, trim + 8)
                    self.synthesize_batch(
                        np.zeros((b, n * hop), np.float32),
                        np.full((b,), ref, np.int32),
                        np.full((b, n), -1, np.int32),
                        np.full((b,), min(n, ref + 8), np.int32),
                        trim_ref_frames=trim,
                    )
                    cond = self._cond_eligible(np.full((b,), ref, np.int32), n)
                    self._warm_trims.setdefault((b, n, cond), set()).add(trim)
                    if cond and b in fallback_batches:
                        # The dispatch above compiled only the cond-cached
                        # variant. A request whose reference exceeds the
                        # cache window (ref_len+4 > cap) falls back to the
                        # waveform program — compile it now too, so that
                        # fallback never pays a cold XLA compile on the
                        # serving path. ref = n-2 guarantees ineligibility.
                        long_ref = n - 2
                        self.synthesize_batch(
                            np.zeros((b, n * hop), np.float32),
                            np.full((b,), long_ref, np.int32),
                            np.full((b, n), -1, np.int32),
                            np.full((b,), n, np.int32),
                            trim_ref_frames=trim,
                        )
                        self._warm_trims.setdefault((b, n, False), set()).add(trim)
