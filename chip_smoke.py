#!/usr/bin/env python
"""Drive the synthesis path once on the GPU, through the normal entry points.

    python chip_smoke.py            # one GPU: every phase below, in order
    python chip_smoke.py --multi    # four GPUs: the mesh phase only

One process drives the card(s); no other JAX process is started. Every phase
checks what it produced and raises on a failure, so the script exits 0 only
when all of them passed. Its last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``. When JAX's first
device is not a GPU it exits non-zero before doing any work.

Phases of the default run, at the full width of the default model
(``ModelConfig()``: DiT 1024 wide, 22 deep, 8 heads × 128, vocoder
512/1536 × 8, NFE 32, bf16) with the deterministic synthetic weight pack:

- device:     JAX's device report, and the card's name and power limit.
- attention:  the attention the DiT uses on the card against the plain
              reference (f32, "highest") at (H, D) ∈ {(8, 128), (16, 64)},
              N ∈ {448, 512, 1024, 2048}, CFG-doubled batch 2B ∈ {2, 16, 64}.
- synthesize: a short sentence (repeated: identical bytes), a catalog voice,
              a voice clone from a WAV written here, a multi-chunk long text
              and the same text streamed.
- serve:      8 concurrent requests through the micro-batcher, then the REST
              app's health and synthesize routes.
- numerics:   the b1@512 mel latent in bf16 against float32 "highest"
              (gated on the pack as served; reported with the AdaLN gates
              open), and, gates open, the bf16 program with the GPU
              attention against the same bf16 program with the plain one.
- train:      3 training steps at full width, b2@512, in bf16.

``--multi`` runs the full-width engine on three 4-device meshes (data, tensor,
sequence parallel) against the same batch on one device: the mel latent in
float32 "highest" and in bf16, and bf16 audio.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

from bench import LONG_TEXT, SHORT_TEXT

CLONE_TEXT = "Giọng nói này được nhân bản từ một đoạn ghi âm ngắn."
CLONE_REF_TEXT = "Đây là đoạn ghi âm mẫu dùng để nhân bản giọng nói."

# Tolerances. Attention: about two bf16 ulps at unit scale plus summation in
# another order. Mel latent: the repo's gate (golden.py). Meshes: f32 shards
# summed in another order.
ATTENTION_TOL = 1e-2
MEL_MAE_TOL = 1e-2
MESH_TOL = 1e-3
# Mel-latent MAE between two bf16 programs that differ only in the attention
# implementation: twice the H100's reading, 4.24e-3, at b4 and b8 @512 with
# the gates open; telling cuDNN every key is valid reads 4.0e-2 (PERF.md).
TRANSLATION_TOL = 8.5e-3
# A mesh's bf16 latent against one device's: each may drift from float32 by
# up to the repo's gate, so they may differ by twice it.
MESH_BF16_TOL = 2 * MEL_MAE_TOL
# AdaLN gate scale for the numerics, train and mesh phases: the synthetic
# pack's gates are zero (every DiT block is the identity at init), which
# would leave attention out of those comparisons.
GATE_STD = 0.02


# Shapes the phases run at.
ATTENTION_HEADS = ((8, 128), (16, 64))  # (H, D): the default model, an F5 pack
ATTENTION_FRAMES = (448, 512, 1024, 2048)
ATTENTION_BATCHES = (2, 16, 64)  # CFG-doubled
# Rows of the f32 reference at the longest bucket: its logits at 2B=64,
# N=2048 would take 17 GB.
ATTENTION_REF_ROWS_2048 = 16
NUMERICS_FRAMES = 512
TRANSLATION_BATCH = 4
REF_FRAMES = 188
TRAIN_BATCH = 2
TRAIN_FRAMES = 512
SERVE_REQUESTS = 8
MESH_BATCH = 8
MESH_FRAMES = 512
MESH_DEVICES = 4
OUT_DIR = Path("output") / "chip_smoke"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def open_gates(params: dict, seed: int = 0) -> dict:
    """Copy of a weight pack with random AdaLN modulation weights."""
    rng = np.random.default_rng(seed)
    dit = dict(params["dit"])
    dit["blocks"] = dict(dit["blocks"])
    for holder, key in ((dit["blocks"], "ada"), (dit, "final_ada")):
        holder[key] = {
            k: rng.normal(0.0, GATE_STD, v.shape).astype(np.float32)
            for k, v in holder[key].items()
        }
    return {**params, "dit": dit}


# ---------------------------------------------------------------------------
# Phases of the default run
# ---------------------------------------------------------------------------


def phase_device(state: dict) -> None:
    from vietvoice_tts_tpu.utils.device import card_name_and_power_limit, jax_device

    d = jax_device()
    say("device", f"platform={d['platform']} device_kind={d['kind']} count={d['count']}")
    say("device", f"nvidia-smi name, power.limit: {card_name_and_power_limit()}")


def phase_attention(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    from vietvoice_tts_tpu.ops.attention import (
        PLAIN,
        choose_attention,
        packed_rope_attention,
    )
    from vietvoice_tts_tpu.ops.rope import rope_tables

    worst = 0.0
    for heads, hd in ATTENTION_HEADS:
        impl = choose_attention(jax.default_backend(), jnp.bfloat16, hd)
        fused = jax.jit(packed_rope_attention, static_argnames=("heads", "impl"))
        for n in ATTENTION_FRAMES:
            cos, sin = (jnp.asarray(t) for t in rope_tables(n, hd))
            for b2 in ATTENTION_BATCHES:
                rng = np.random.default_rng(heads * 100_000 + n * 100 + b2)
                qkv = jnp.asarray(
                    rng.standard_normal((b2, n, 3 * heads * hd), np.float32),
                    jnp.bfloat16,
                )
                lengths = rng.integers(n // 2, n + 1, b2)
                lengths[0] = n
                mask = jnp.asarray(np.arange(n)[None, :] < lengths[:, None])
                out = fused(qkv, cos, sin, mask, heads=heads, impl=impl)
                rows = b2 if n < 2048 else min(b2, ATTENTION_REF_ROWS_2048)
                with jax.default_matmul_precision("highest"):
                    want = fused(
                        qkv[:rows].astype(jnp.float32), cos, sin, mask[:rows],
                        heads=heads, impl=PLAIN,
                    )
                diff = jnp.abs(out[:rows].astype(jnp.float32) - want)
                err = float(jnp.max(jnp.where(mask[:rows, :, None], diff, 0.0)))
                check(bool(jnp.isfinite(out).all()), "attention output finite")
                worst = max(worst, err)
                say(
                    "attention",
                    f"H={heads} D={hd} N={n} 2B={b2} impl={impl} "
                    f"rows compared={rows}: max abs err {err:.3e} "
                    f"(tol {ATTENTION_TOL:g})",
                )
                check(err <= ATTENTION_TOL, f"attention error {err} > {ATTENTION_TOL}")
    say("attention", f"worst max abs err {worst:.3e} (tol {ATTENTION_TOL:g})")


def _expected_samples(engine, text: str, **voice) -> tuple[int, int]:
    """(chunks, samples) the planner gives ``text``: per chunk the target
    frames times hop, less one cross-fade per chunk boundary."""
    cfg = engine.config
    ref_audio, ref_text = engine.model_session_manager.select_sample(**voice)
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    plans = engine._plan_chunks(ref, ref_text, text)
    fade = int(cfg.cross_fade_duration * cfg.sample_rate)
    total = sum((p.total_len - p.ref_len) * cfg.hop_length for p in plans)
    return len(plans), total - fade * (len(plans) - 1)


def _check_audio(name: str, wave: np.ndarray, expected: int) -> None:
    check(wave.dtype == np.int16, f"{name}: int16 output (got {wave.dtype})")
    check(wave.size > 0, f"{name}: non-empty output")
    check(bool(np.any(wave != 0)), f"{name}: nonzero output")
    check(wave.size == expected, f"{name}: {wave.size} samples, expected {expected}")


def _clone_wav(path: Path, sample_rate: int, seconds: float = 3.0) -> None:
    """A voiced-sounding reference clip: harmonics of a gliding pitch under
    a syllable-rate envelope, seeded."""
    from vietvoice_tts_tpu.utils.wavio import write_wav

    t = np.arange(int(seconds * sample_rate)) / sample_rate
    f0 = 140.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    voice = sum(np.sin(k * phase) / k for k in range(1, 8))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t)) ** 2
    noise = np.random.default_rng(7).normal(0, 0.02, t.size)
    wave = 0.25 * voice * env / np.abs(voice * env).max() + noise
    path.parent.mkdir(parents=True, exist_ok=True)
    write_wav((np.clip(wave, -1, 1) * 32767).astype(np.int16), path, sample_rate)


def phase_synthesize(state: dict) -> None:
    from vietvoice_tts_tpu import ModelConfig, TTSApi

    cfg = ModelConfig()
    say(
        "synthesize",
        f"ModelConfig: DiT {cfg.dit_dim} wide, {cfg.dit_depth} deep, "
        f"{cfg.dit_heads} heads x {cfg.head_dim}; vocoder "
        f"{cfg.vocoder_dim}/{cfg.vocoder_intermediate_dim} x "
        f"{cfg.vocoder_num_layers}; NFE {cfg.nfe_step}; {cfg.compute_dtype}; "
        f"pack {cfg.model_path}",
    )
    api = state["api"] = TTSApi(cfg)
    t0 = time.perf_counter()
    engine = api.engine
    say("synthesize", f"weight pack loaded (materialized if absent) in "
        f"{time.perf_counter() - t0:.1f} s")

    clone_path = OUT_DIR / "clone_reference.wav"
    _clone_wav(clone_path, cfg.sample_rate)
    cases = [
        ("short sentence", SHORT_TEXT, {}),
        ("catalog voice male/southern", SHORT_TEXT,
         {"gender": "male", "area": "southern"}),
        ("voice clone", CLONE_TEXT,
         {"reference_audio": str(clone_path), "reference_text": CLONE_REF_TEXT}),
        ("long text", LONG_TEXT, {}),
    ]
    for name, text, voice in cases:
        chunks, expected = _expected_samples(engine, text, **voice)
        t0 = time.perf_counter()
        first, _ = api.synthesize(text, **voice)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        again, _ = api.synthesize(text, **voice)
        t_run = time.perf_counter() - t0
        _check_audio(name, first, expected)
        same = np.array_equal(first, again)
        say(
            "synthesize",
            f"{name}: {chunks} chunk(s), {first.size} samples "
            f"({first.size / cfg.sample_rate:.2f} s audio); first call "
            f"{t_first:.2f} s = compile {t_first - t_run:.2f} s + run; "
            f"run {t_run:.3f} s; repeat byte-identical: {same}",
        )
        check(same, f"{name}: repeat is byte-identical")
        if name == "short sentence":
            state["short"] = first
        if name == "long text":
            check(chunks >= 2, f"long text splits into chunks (got {chunks})")
            long_wave = first
    _check_streaming(api, long_wave)


def _check_streaming(api, long_wave: np.ndarray) -> None:
    """The long text streamed. Streaming dispatches each chunk as its own
    one-row program while ``synthesize()`` runs a bucket's chunks as one
    batch; on the GPU the two programs may pick different GEMM kernels and
    round differently. So the stream is held to the blocking concatenation
    of the same one-row chunk waves (byte-identical), and its distance from
    ``synthesize()`` is reported."""
    engine = api.engine
    cfg = engine.config
    t0 = time.perf_counter()
    pieces = list(api.synthesize_streaming(LONG_TEXT))
    t_stream = time.perf_counter() - t0
    streamed = np.concatenate(pieces)
    check(len(pieces) >= 2, f"streaming: several pieces (got {len(pieces)})")
    _check_audio("streaming", streamed, long_wave.size)

    ref_audio, ref_text = engine.model_session_manager.select_sample()
    ref = engine._load_ref(ref_audio).astype(np.float32) / 32768.0
    plans = engine._plan_chunks(ref, ref_text, LONG_TEXT)
    waves = list(engine._iter_chunk_waves(plans, ref))
    joined = engine.audio_processor.concatenate_with_crossfade_improved(
        waves, cfg.cross_fade_duration, cfg.sample_rate)
    check(np.array_equal(streamed, joined),
          "streaming: pieces equal the blocking cross-fade of the same chunk waves")
    diff = int(np.abs(streamed.astype(np.int32) - long_wave).max())
    say("synthesize", f"streaming long text: {len(pieces)} pieces, "
        f"{streamed.size} samples, equal to the blocking cross-fade of its "
        f"one-row chunk waves: True; max |stream - synthesize()| {diff} int16 "
        f"steps (one-row vs {len(plans)}-row chunk programs); {t_stream:.2f} s "
        "(first call of its program shape included)")


def phase_serve(state: dict) -> None:
    import importlib

    import jax

    api = state["api"]
    engine = api.engine
    n = SERVE_REQUESTS
    # A generous collection window: the batch goes out once all n requests
    # (one bucket) have arrived.
    batcher = engine.enable_micro_batching(max_batch=n, max_wait_ms=30_000.0)
    results: list = [None] * n
    errors: list = []

    def one(i: int) -> None:
        try:
            results[i] = api.synthesize(SHORT_TEXT)[0]
        except Exception as e:  # noqa: BLE001 — reported by the check below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "serve: every request returned")
    check(not errors, f"serve: no request failed ({errors})")
    stats = batcher.stats
    say("serve", f"{n} concurrent requests answered in {wall:.2f} s (first "
        f"dispatch of batch {n} compiles); dispatches={stats.batches} "
        f"jobs={stats.jobs} padded_rows={stats.padded_rows} mean batch size "
        f"{stats.mean_batch_size:g}")
    check(stats.jobs == n and stats.batches == 1,
          f"serve: all {n} requests in one batched dispatch")
    ref = state["short"]
    for i, w in enumerate(results):
        _check_audio(f"served request {i}", w, ref.size)
    diff = max(int(np.abs(w.astype(np.int32) - ref).max()) for w in results)
    say("serve", f"max |served - direct| over the 8 rows: {diff} (int16 steps; "
        "the batch-8 program may round differently from the batch-1 one)")

    batcher.shutdown()
    engine.batcher = None

    # The REST app (pydantic is installed on the card's machine), serving
    # through a micro-batcher with its default collection window.
    from vietvoice_tts_tpu.api import tts_engine
    from vietvoice_tts_tpu.api.asgi import AsyncTestClient
    from vietvoice_tts_tpu.utils.wavio import read_wav

    app_module = importlib.import_module("vietvoice_tts_tpu.api.app")
    client = AsyncTestClient(app_module.app)
    engine.enable_micro_batching()
    tts_engine._engine = api  # serve through the engine loaded above
    try:
        health = asyncio.run(client.get("/api/v1/health"))
        check(health.status_code == 200, f"health: HTTP {health.status_code}")
        h = health.json()
        say("serve", f"GET /api/v1/health -> 200 {h}")
        check(h["backend"] == jax.default_backend(), "health reports the backend")
        t0 = time.perf_counter()
        resp = asyncio.run(client.post("/api/v1/synthesize", json={"text": SHORT_TEXT}))
        t_rest = time.perf_counter() - t0
        check(resp.status_code == 200, f"synthesize: HTTP {resp.status_code}")
        samples, sr = read_wav(resp.content)
        pcm = np.asarray(samples).reshape(-1)
        check(sr == api.config.sample_rate and pcm.size == ref.size,
              "REST audio has the direct call's rate and length")
        check(bool(np.any(pcm != 0)), "REST audio nonzero")
        say("serve", f"POST /api/v1/synthesize -> 200, {len(resp.content)} "
            f"bytes of WAV, {pcm.size} samples at {sr} Hz, {t_rest:.3f} s")
    finally:
        tts_engine._engine = None
        engine.batcher.shutdown()
        engine.batcher = None


def _latent_inputs(cfg, b: int, n: int, ref_frames: int, seed: int):
    rng = np.random.default_rng(seed)
    hop = cfg.hop_length
    wave = np.zeros((b, n * hop), np.float32)
    wave[:, : ref_frames * hop] = rng.uniform(-0.4, 0.4, (b, ref_frames * hop))
    total = np.full((b,), n, np.int32)
    total[1:] = rng.integers(n - n // 4, n + 1, b - 1)
    ids = np.full((b, n), -1, np.int32)
    for i in range(b):
        ids[i, : total[i] // 2] = rng.integers(1, 60, total[i] // 2)
    x0 = rng.standard_normal((b, n, cfg.n_mels)).astype(np.float32)
    return wave, np.full((b,), ref_frames, np.int32), ids, total, x0


@contextlib.contextmanager
def plain_attention():
    """DiT programs traced inside take the plain attention whatever the
    device; yields the list of choices it made, to show it was consulted."""
    from vietvoice_tts_tpu.models import dit
    from vietvoice_tts_tpu.ops.attention import PLAIN

    chosen, made = dit.choose_attention, []

    def plain(*args):
        made.append(args)
        return PLAIN

    dit.choose_attention = plain
    try:
        yield made
    finally:
        dit.choose_attention = chosen


def _target_mae(got: np.ndarray, want: np.ndarray, ref_len, total) -> tuple:
    """(MAE, max abs) over each row's generated frames [ref_len, total)."""
    f = np.arange(got.shape[1])[None, :]
    target = ((f >= np.asarray(ref_len)[:, None]) & (f < np.asarray(total)[:, None]))
    d = np.abs(got - want)[target]
    return float(d.mean()), float(d.max())


def _translation(label: str, cfg, params, vocab: int, inputs, mesh=None):
    """Gate one bf16 program with the attention ``choose_attention`` picks
    against the same program with the plain attention; returns the engine
    and its mel latent."""
    import jax

    from vietvoice_tts_tpu.ops.attention import choose_attention
    from vietvoice_tts_tpu.runtime.engine_core import EngineCore

    impl = choose_attention(jax.default_backend(), cfg.compute_dtype, cfg.head_dim)
    wave, ref_len, ids, total, x0 = inputs
    t0 = time.perf_counter()
    core = EngineCore(cfg, params, vocab, mesh=mesh)
    got = core.mel_latent_batch(wave, ref_len, ids, total, x0=x0)
    with plain_attention() as made:
        want = EngineCore(cfg, params, vocab, mesh=mesh).mel_latent_batch(
            wave, ref_len, ids, total, x0=x0)
    check(bool(made), "the reference program was traced with the plain attention")
    mae, worst = _target_mae(got, want, ref_len, total)
    say("translation", f"{label}, lengths {total.tolist()}, AdaLN gates open: "
        f"{cfg.compute_dtype} mel latent with attention={impl} vs the plain "
        f"attention: MAE {mae:.3e} (tol {TRANSLATION_TOL:g}), max abs "
        f"{worst:.3e}; {time.perf_counter() - t0:.2f} s")
    check(np.isfinite(mae) and mae <= TRANSLATION_TOL,
          f"{label}: translation MAE {mae} > {TRANSLATION_TOL}")
    return core, got


def phase_numerics(state: dict) -> None:
    import golden

    engine = state["api"].engine
    cfg = engine.config
    session = engine.model_session_manager
    n, r = NUMERICS_FRAMES, REF_FRAMES
    params = state["params"] = open_gates(session.params)
    # Against float32 "highest": gated on the weight pack as served; reported
    # with the AdaLN gates open, where bf16's own drift sits near the gate.
    for label, p in (("pack as served", None), ("AdaLN gates open", params)):
        t0 = time.perf_counter()
        row = golden.precision_drift(
            cfg.model_path, frames=(n,), ref_frames=r, params=p
        )["rows"][0]
        say("numerics", f"b1@{n} mel latent, {cfg.compute_dtype} (the GPU "
            f"attention) vs float32 'highest' (plain attention), {label}: "
            f"MAE {row['mel_mae']:.3e}, max abs {row['mel_max_abs']:.3e}, "
            f"relative MAE {row['rel_mae']:.3e}"
            + (f" (tol {MEL_MAE_TOL:g})" if p is None else " (not gated)")
            + f"; {time.perf_counter() - t0:.2f} s")
        check(np.isfinite(row["mel_mae"]), "mel drift finite")
        if p is None:
            check(row["mel_mae"] <= MEL_MAE_TOL,
                  f"mel MAE {row['mel_mae']} > {MEL_MAE_TOL}")

    # The translation alone: with the gates open, the serving program as it
    # runs on the card against the same program in the same dtype with the
    # plain attention, on rows of different lengths (padded keys and
    # queries), so that only the attention implementation differs.
    inputs = _latent_inputs(cfg, TRANSLATION_BATCH, n, r, seed=11)
    _translation(f"b{TRANSLATION_BATCH}@{n} on one device", cfg, params,
                 session.vocab_size, inputs)
    state["dit_cfg"] = engine.engine_core.dit_cfg


def phase_train(state: dict) -> None:
    import jax

    from vietvoice_tts_tpu.training.train import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    dit_cfg = state["dit_cfg"]
    tc = TrainConfig(compute_dtype="bfloat16")
    params = jax.device_put(state["params"]["dit"])
    opt_state = init_train_state(params, tc)
    step = jax.jit(make_train_step(dit_cfg, tc))
    b, n = TRAIN_BATCH, TRAIN_FRAMES
    rng = np.random.default_rng(5)
    mel = rng.normal(-4.0, 2.0, (b, n, dit_cfg.n_mels)).astype(np.float32)
    ids = np.full((b, n), -1, np.int32)
    ids[:, : n // 3] = rng.integers(1, 60, (b, n // 3))
    lengths = np.array([n] + [n - n // 5] * (b - 1), np.int32)
    key = jax.random.PRNGKey(0)
    for i in range(3):
        t0 = time.perf_counter()
        params, opt_state, loss = step(
            params, opt_state, jax.random.fold_in(key, i), mel, ids, lengths
        )
        loss = float(loss)
        say("train", f"step {i}: loss {loss:.4f} in {time.perf_counter() - t0:.2f} s"
            + (" (compile included)" if i == 0 else ""))
        check(np.isfinite(loss), f"train step {i}: finite loss")


# ---------------------------------------------------------------------------
# The four-device phase
# ---------------------------------------------------------------------------


def phase_multi(state: dict) -> None:
    import jax

    from vietvoice_tts_tpu import ModelConfig
    from vietvoice_tts_tpu.parallel.mesh import make_mesh
    from vietvoice_tts_tpu.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu.runtime.session import ModelSessionManager

    check(len(jax.devices()) >= MESH_DEVICES,
          f"{MESH_DEVICES} devices (found {len(jax.devices())})")
    cfg = ModelConfig()
    session = ModelSessionManager(cfg)
    session.load_models()
    params = open_gates(session.params)
    vocab = session.vocab_size
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32", transfer_dtype="float32")
    b, n, r = MESH_BATCH, MESH_FRAMES, REF_FRAMES
    inputs = _latent_inputs(cfg, b, n, r, seed=13)
    wave, ref_len, ids, total, x0 = inputs
    valid = (np.arange(n)[None, :] < total[:, None])[..., None]

    single = EngineCore(cfg32, params, vocab)
    with jax.default_matmul_precision("highest"):
        want = single.mel_latent_batch(wave, ref_len, ids, total, x0=x0)
    want16 = EngineCore(cfg, params, vocab).mel_latent_batch(
        wave, ref_len, ids, total, x0=x0)
    say("multi", f"one device: b{b}@{n} mel latent in float32 'highest' and in "
        f"{cfg.compute_dtype}, mean |latent| {float(np.abs(want).mean()):.3f}")
    k = MESH_DEVICES
    meshes = (
        ("data parallel", {"mesh_data_axis": k}),
        ("tensor parallel", {"mesh_model_axis": k}),
        ("sequence parallel", {"mesh_model_axis": k, "sequence_parallel": True}),
    )
    for name, axes in meshes:
        mcfg = dataclasses.replace(cfg32, **axes)
        mesh = make_mesh(mcfg.mesh_data_axis, mcfg.mesh_model_axis)
        core = EngineCore(mcfg, params, vocab, mesh=mesh)
        t0 = time.perf_counter()
        with jax.default_matmul_precision("highest"):
            got = core.mel_latent_batch(wave, ref_len, ids, total, x0=x0)
        t_f32 = time.perf_counter() - t0
        err = float(np.abs(np.where(valid, got - want, 0.0)).max())
        say("multi", f"{name} {dict(mesh.shape)}: f32 'highest' mel latent max abs "
            f"err vs one device {err:.3e} (tol {MESH_TOL:g}); {t_f32:.2f} s")
        check(err <= MESH_TOL, f"{name}: error {err} > {MESH_TOL}")

        bcore, got16 = _translation(name, dataclasses.replace(cfg, **axes),
                                    params, vocab, inputs, mesh=mesh)
        mae, worst = _target_mae(got16, want16, ref_len, total)
        say("multi", f"{name}: {cfg.compute_dtype} mel latent vs one device in "
            f"{cfg.compute_dtype}: MAE {mae:.3e} (tol {MESH_BF16_TOL:g}), max "
            f"abs {worst:.3e}")
        check(np.isfinite(mae) and mae <= MESH_BF16_TOL,
              f"{name}: {cfg.compute_dtype} MAE {mae} > {MESH_BF16_TOL}")
        t0 = time.perf_counter()
        pcm = bcore.synthesize_batch(wave, ref_len, ids, total, seed=np.arange(b))
        t_bf16 = time.perf_counter() - t0
        check(pcm.dtype == np.int16 and pcm.shape == (b, n * cfg.hop_length),
              f"{name}: int16 audio of shape {(b, n * cfg.hop_length)}")
        check(bool(np.any(pcm != 0)), f"{name}: nonzero bf16 audio")
        say("multi", f"{name}: bf16 audio int16 {pcm.shape}, nonzero; {t_bf16:.2f} s")


DEFAULT_PHASES = (
    ("device", phase_device),
    ("attention", phase_attention),
    ("synthesize", phase_synthesize),
    ("serve", phase_serve),
    ("numerics", phase_numerics),
    ("train", phase_train),
)
MULTI_PHASES = (("device", phase_device), ("multi", phase_multi))


def run_phases(phases) -> None:
    state: dict = {}
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            fn(state)
            say(name, f"passed in {time.perf_counter() - t0:.1f} s")
    finally:
        if "api" in state:
            state["api"].engine.cleanup()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device mesh phase")
    args = ap.parse_args(argv)

    from vietvoice_tts_tpu.utils.device import require_gpu

    try:
        device = require_gpu()
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    run_phases(MULTI_PHASES if args.multi else DEFAULT_PHASES)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
