#!/usr/bin/env python
"""Golden numerics harness: mel comparison vs the ONNX reference.

BASELINE.json gates numerics on "mel allclose (atol 1e-2) vs the ONNX
reference per utterance". ORT's RNG is not reproducible from ``jax.random``,
so the protocol shares the *reference's* noise tensor (SURVEY §7 hard part
(c); reference loop semantics at
``/root/reference/vietvoicetts/core/tts_engine.py:148-187``):

1. **Reference side** (needs ``onnxruntime`` + the model tarball): run the
   preprocess graph, capture its noise tensor, run the transformer loop to
   the final mel latent. ``--save-ref out.npz`` stores these arrays so the
   reference side can run on any machine that has ORT, once.
2. **Engine side** (this repo, always runnable): convert the tarball into a
   weight pack (``models/convert.py``), rebuild the conditioning from the
   same reference audio, and integrate OUR sampler from the SAME noise via
   ``EngineCore.mel_latent_batch(x0=...)``.
3. Compare final mel latents over the synthesized (non-reference) region:
   MAE, max-abs, allclose at ``--atol``.

Runnable forms::

    python golden.py --onnx-tarball model-bin.pt             # both sides
    python golden.py --onnx-tarball model-bin.pt --save-ref ref.npz
    python golden.py --ref-npz ref.npz --pack packs/v1       # engine side only

Prints ONE JSON line; status "skipped" (with the reason) when the reference
artifacts are absent, so CI can record the gate without network access. The
harness itself is proven by ``tests/test_golden.py``, which generates a
ref-npz from a known oracle and checks the engine side reports mel_mae ≈ 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# Reference side (requires onnxruntime; runs the real ONNX graphs)
# ---------------------------------------------------------------------------


def _session_factory():
    """ORT when installed, else the built-in numpy evaluator
    (``models/onnx_eval.py``) — same ``run``/``get_inputs`` surface."""
    try:
        import onnxruntime as ort

        return lambda data: ort.InferenceSession(data)
    except ImportError:
        from vietvoice_tts_tpu.models.onnx_eval import EvalSession

        return EvalSession


def reference_side(tarball: str, text: str, nfe_step: int = 32) -> dict:
    """Run the reference graphs → {audio, combined_text, noise, ref_mel,
    ref_signal_len, nfe_step}. Mirrors ``core/tts_engine.py:133-187``.
    ``nfe_step`` must match the graph's embedded schedule (32 for the real
    model, ``core/model_config.py:29``; fixture tests use fewer)."""
    import tarfile

    from vietvoice_tts_tpu.pipeline.audio import AudioProcessor
    from vietvoice_tts_tpu.pipeline.text import TextProcessor
    from vietvoice_tts_tpu.models.convert import extract_assets

    make_session = _session_factory()

    with tempfile.TemporaryDirectory() as td:
        assets = extract_assets(tarball, td)
        if not assets["vocab"]:
            raise RuntimeError("tarball holds no vocab.txt")
        tp = TextProcessor(str(Path(td) / "vocab.txt"))
        meta = json.loads((Path(td) / "audio_metadata.json").read_text())
        sample = meta[0]
        ref_audio_path = Path(td) / "audios" / sample["file_name"]
        ref_text = sample["text"]

        ap = AudioProcessor()
        ref_int16 = ap.load_audio(str(ref_audio_path), 24000)
        audio_f32 = ref_int16.astype(np.float32)

        sessions = {}
        with tarfile.open(tarball) as tar:
            for member in tar.getmembers():
                if member.name.endswith(".onnx"):
                    stem = Path(member.name).stem
                    sessions[stem] = make_session(tar.extractfile(member).read())
        pre, trans = sessions["preprocess"], sessions["transformer"]

        combined = tp.clean_text(ref_text) + tp.clean_text(text)
        # Reference feeds [1, L] int64 char ids (unk→0, text_processor.py:30).
        text_ids = tp.text_to_indices([list(combined)]).astype(np.int64)
        # Duration heuristic parity (core/tts_engine.py:54-64, speed 0.9).
        ref_frames = len(audio_f32) // 256 + 1
        rate = tp.calculate_text_length(ref_text, ".,?!:") / (len(audio_f32) / 24000.0)
        tgt_dur = max(tp.calculate_text_length(tp.clean_text(text), ".,?!:") / rate / 0.9, 1.0)
        max_duration = np.asarray([ref_frames + int(tgt_dur * 24000) // 256 + 1], np.int64)

        pre_inputs = {
            i.name: v
            for i, v in zip(
                pre.get_inputs(),
                (audio_f32.reshape(1, 1, -1), text_ids, max_duration),
            )
        }
        outs = pre.run(None, pre_inputs)
        noise, ref_signal_len = outs[0], outs[-1]

        t_names = [i.name for i in trans.get_inputs()]
        state = list(outs[: len(t_names) - 1]) + [np.asarray([0], np.int32)]
        for _ in range(0, nfe_step - 1):
            o = trans.run(None, dict(zip(t_names, state)))
            state[0], state[-1] = o[0], o[1]
        return {
            "audio": audio_f32 / 32768.0,
            "combined_text": combined,
            "noise": np.asarray(noise, np.float32),
            "ref_mel": np.asarray(state[0], np.float32),
            "ref_signal_len": int(np.asarray(ref_signal_len).reshape(-1)[0]),
            "nfe_step": nfe_step,
        }


# ---------------------------------------------------------------------------
# Engine side (always runnable)
# ---------------------------------------------------------------------------


def _as_latent_layout(a: np.ndarray, n_mels: int) -> np.ndarray:
    """Coerce a reference tensor into our [B, N, n_mels] layout."""
    a = np.asarray(a, np.float32)
    if a.ndim == 2:
        a = a[None]
    if a.shape[-1] != n_mels and a.shape[-2] == n_mels:
        a = np.swapaxes(a, -1, -2)  # [B, n_mels, N] → [B, N, n_mels]
    return a


def _latent_inputs(cfg, pack: Path, ref: dict):
    """Shared input prep: (wave, ref_len, ids, total_len, noise, ref_mel)."""
    from vietvoice_tts_tpu.pipeline.text import TextProcessor

    noise = _as_latent_layout(ref["noise"], cfg.n_mels)
    ref_mel = _as_latent_layout(ref["ref_mel"], cfg.n_mels)
    n_frames = noise.shape[1]
    hop = cfg.hop_length

    audio = np.asarray(ref["audio"], np.float32).reshape(-1)
    wave = np.zeros((1, n_frames * hop), np.float32)
    wave[0, : min(len(audio), n_frames * hop)] = audio[: n_frames * hop]

    tp = TextProcessor(str(pack / "vocab.txt"))
    ids, _ = tp.encode_padded(str(ref["combined_text"]), n_frames)
    ref_len = int(ref["ref_signal_len"])
    return wave, ref_len, ids, n_frames, noise, ref_mel


def cfg_cache_sweep(
    pack_dir,
    ref: dict,
    intervals=(1, 2, 4),
    repeats: int = 3,
    **config_overrides,
) -> dict:
    """Price the CFG cache: mel drift + step time per ``nfe_uncond_interval``.

    For each k the full latent pipeline runs from the SAME noise; k=1 is the
    exact-reference-semantics baseline (``models/sampler.py``). Reported per
    k: mel MAE/max-abs drift vs the k=1 latent over the synthesized region,
    MAE vs the ONNX reference mel when available, and best-of-``repeats``
    wall time (dispatch+fetch). Drift is REPORTED, not judged — quality
    acceptance is a decision for real weights (round-3 verdict #5)."""
    import time as _time

    from vietvoice_tts_tpu.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu.runtime.serialization import PARAMS_FILE, load_params
    from vietvoice_tts_tpu.runtime.session import config_from_pack

    import jax

    pack = Path(pack_dir)
    params = load_params(pack / PARAMS_FILE)
    rows = []
    base_latent = None
    for k in intervals:
        cfg = config_from_pack(
            pack,
            nfe_step=int(ref["nfe_step"]),
            nfe_uncond_interval=int(k),
            **config_overrides,
        )
        core = EngineCore(cfg, params, cfg.vocab_size)
        wave, ref_len, ids, n_frames, noise, ref_mel = _latent_inputs(cfg, pack, ref)
        args = (
            wave,
            np.asarray([ref_len], np.int32),
            ids[None],
            np.asarray([n_frames], np.int32),
        )
        # f32 mode wants TRUE f32 (DEFAULT precision may run f32 matmuls
        # at reduced precision on an accelerator — see engine_side);
        # serving mode measures reality, timings included.
        ctx = (
            jax.default_matmul_precision("highest")
            if str(cfg.compute_dtype) == "float32"
            else contextlib.nullcontext()
        )
        with ctx:
            latent = core.mel_latent_batch(*args, x0=noise)  # compile + result
        times = []
        with ctx:
            for _ in range(max(1, repeats)):
                t0 = _time.perf_counter()
                core.mel_latent_batch(*args, x0=noise)
                times.append(_time.perf_counter() - t0)
        target = slice(ref_len, n_frames)
        if base_latent is None:
            base_latent = latent
        drift = np.abs(latent[0, target] - base_latent[0, target])
        vs_ref = np.abs(latent[0, target] - ref_mel[0, target])
        rows.append(
            {
                "uncond_interval": int(k),
                "mel_mae_vs_exact": float(drift.mean()),
                "mel_max_abs_vs_exact": float(drift.max()),
                "mel_mae_vs_onnx": float(vs_ref.mean()),
                "latent_ms": round(min(times) * 1e3, 2),
            }
        )
    base_ms = rows[0]["latent_ms"]
    for r in rows:
        r["speedup_vs_exact"] = round(base_ms / r["latent_ms"], 3) if r["latent_ms"] else None
    return {"metric": "cfg_cache_price", "frames": int(rows and n_frames), "rows": rows}


def deep_cache_sweep(
    pack_dir,
    ref: dict,
    settings=((1, 7), (2, 7), (2, 11), (3, 7)),
    repeats: int = 3,
    **config_overrides,
) -> dict:
    """Price the deep-block cache: mel drift + step time per (interval r,
    shallow blocks j) setting (``models/sampler.py`` deep_cache_*).

    Same protocol as :func:`cfg_cache_sweep`: every setting integrates from
    the SAME noise; the first setting (interval 1) is the exact baseline.
    Drift is REPORTED, not judged — quality acceptance is a decision for
    real weights, like every other priced knob."""
    import time as _time

    import jax

    from vietvoice_tts_tpu.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu.runtime.serialization import PARAMS_FILE, load_params
    from vietvoice_tts_tpu.runtime.session import config_from_pack

    pack = Path(pack_dir)
    params = load_params(pack / PARAMS_FILE)
    rows = []
    base_latent = None
    for r_int, j in settings:
        cfg = config_from_pack(
            pack,
            nfe_step=int(ref["nfe_step"]),
            nfe_deep_cache_interval=int(r_int),
            nfe_deep_cache_blocks=int(j),
            **config_overrides,
        )
        core = EngineCore(cfg, params, cfg.vocab_size)
        wave, ref_len, ids, n_frames, noise, ref_mel = _latent_inputs(cfg, pack, ref)
        args = (
            wave,
            np.asarray([ref_len], np.int32),
            ids[None],
            np.asarray([n_frames], np.int32),
        )
        ctx = (
            jax.default_matmul_precision("highest")
            if str(cfg.compute_dtype) == "float32"
            else contextlib.nullcontext()
        )
        with ctx:
            latent = core.mel_latent_batch(*args, x0=noise)
        times = []
        with ctx:
            for _ in range(max(1, repeats)):
                t0 = _time.perf_counter()
                core.mel_latent_batch(*args, x0=noise)
                times.append(_time.perf_counter() - t0)
        target = slice(ref_len, n_frames)
        if base_latent is None:
            base_latent = latent
        drift = np.abs(latent[0, target] - base_latent[0, target])
        vs_ref = np.abs(latent[0, target] - ref_mel[0, target])
        rows.append(
            {
                "deep_cache_interval": int(r_int),
                "deep_cache_blocks": int(j),
                "mel_mae_vs_exact": float(drift.mean()),
                "mel_max_abs_vs_exact": float(drift.max()),
                "mel_mae_vs_onnx": float(vs_ref.mean()),
                "latent_ms": round(min(times) * 1e3, 2),
            }
        )
    base_ms = rows[0]["latent_ms"]
    for row in rows:
        row["speedup_vs_exact"] = (
            round(base_ms / row["latent_ms"], 3) if row["latent_ms"] else None
        )
    return {"metric": "deep_cache_price", "frames": int(rows and n_frames), "rows": rows}


def precision_drift(
    pack_dir,
    frames=(384, 448, 512, 704),
    ref_frames: int = 188,
    seed: int = 0,
    params=None,
) -> dict:
    """Serving-precision (bf16 compute / f16 transfer) drift vs f32, per
    frame bucket, on one pack — no ONNX side needed.

    Both runs integrate from the SAME injected noise on the SAME weights;
    the only variable is the serving dtype policy, so the reported MAE is
    exactly the drift `--serving-precision` adds on top of a passing f32
    golden gate (round-3 verdict #9: an expected-drift envelope per bucket,
    recorded before real weights arrive). ``params`` replaces the pack's
    weights (same architecture) when given."""
    from vietvoice_tts_tpu.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu.runtime.serialization import PARAMS_FILE, load_params
    from vietvoice_tts_tpu.runtime.session import config_from_pack

    pack = Path(pack_dir)
    if params is None:
        params = load_params(pack / PARAMS_FILE)
    cfg32 = config_from_pack(
        pack, compute_dtype="float32", transfer_dtype="float32"
    )
    cfg_srv = config_from_pack(pack)  # the pack's serving defaults
    core32 = EngineCore(cfg32, params, cfg32.vocab_size)
    core_srv = EngineCore(cfg_srv, params, cfg_srv.vocab_size)

    rng = np.random.default_rng(seed)
    hop = cfg32.hop_length
    rows = []
    for n in frames:
        wave = np.zeros((1, n * hop), np.float32)
        wave[0, : ref_frames * hop] = rng.uniform(-0.4, 0.4, ref_frames * hop)
        ids = np.full((1, n), -1, np.int32)
        ids[0, : n // 2] = rng.integers(1, 60, n // 2)
        x0 = rng.standard_normal((1, n, cfg32.n_mels)).astype(np.float32)
        args = (
            wave,
            np.asarray([ref_frames], np.int32),
            ids,
            np.asarray([n], np.int32),
        )
        import jax

        # True-f32 baseline: DEFAULT precision may run f32 matmuls at
        # reduced precision (see engine_side) — the drift would measure ~0.
        with jax.default_matmul_precision("highest"):
            lat32 = core32.mel_latent_batch(*args, x0=x0)
        lat_srv = core_srv.mel_latent_batch(*args, x0=x0)
        d = np.abs(lat32[0, ref_frames:] - lat_srv[0, ref_frames:])
        scale = float(np.abs(lat32[0, ref_frames:]).mean())
        rows.append(
            {
                "frames": int(n),
                "mel_mae": float(d.mean()),
                "mel_max_abs": float(d.max()),
                "rel_mae": float(d.mean() / scale) if scale else None,
            }
        )
    return {
        "metric": "serving_precision_drift",
        "compute_dtype": str(cfg_srv.compute_dtype),
        "ref_frames": ref_frames,
        "rows": rows,
    }


def engine_side(pack_dir, ref: dict, atol: float = 1e-2, **config_overrides) -> dict:
    """Integrate OUR sampler from the reference's noise; compare mels.

    ``ref`` needs: audio (f32 [-1,1]), combined_text, noise, ref_mel,
    ref_signal_len, nfe_step. Returns the comparison report (one dict).
    ``config_overrides`` reach the ModelConfig — fixture rehearsals pass
    ``compute_dtype="float32", transfer_dtype="float32"`` to isolate
    conversion bugs from serving-precision noise; the real gate runs the
    serving defaults (bf16 compute) because that's what ships."""
    import jax

    from vietvoice_tts_tpu.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu.runtime.serialization import PARAMS_FILE, load_params
    from vietvoice_tts_tpu.runtime.session import config_from_pack

    pack = Path(pack_dir)
    cfg = config_from_pack(pack, nfe_step=int(ref["nfe_step"]), **config_overrides)
    params = load_params(pack / PARAMS_FILE)
    core = EngineCore(cfg, params, cfg.vocab_size)

    wave, ref_len, ids, n_frames, noise, ref_mel = _latent_inputs(cfg, pack, ref)
    # On an accelerator, f32 matmuls at DEFAULT precision may take reduced-
    # precision inputs (TF32 on the GPU), which drifts over a full-depth
    # 31-step solve and can FAIL the 1e-2 gate even with perfect weights
    # (CPU runs are exact). The f32 numerics mode therefore forces
    # 'highest'; serving-precision mode measures reality.
    f32_mode = str(cfg.compute_dtype) == "float32"
    ctx = (
        jax.default_matmul_precision("highest")
        if f32_mode
        else contextlib.nullcontext()
    )
    with ctx:
        latent = core.mel_latent_batch(
            wave,
            np.asarray([ref_len], np.int32),
            ids[None],
            np.asarray([n_frames], np.int32),
            x0=noise,
        )

    target = slice(ref_len, n_frames)
    diff = np.abs(latent[0, target] - ref_mel[0, target])
    full_diff = np.abs(latent[0] - ref_mel[0])
    return {
        "metric": "mel_mae_vs_onnx",
        "status": "ok",
        "mel_mae": float(diff.mean()),
        "mel_max_abs": float(diff.max()),
        "mel_mae_full": float(full_diff.mean()),
        "allclose": bool(np.allclose(latent[0, target], ref_mel[0, target], atol=atol)),
        "atol": atol,
        "frames": int(n_frames),
        "ref_frames": ref_len,
    }


def _skip(reason: str) -> int:
    print(json.dumps({"metric": "mel_mae_vs_onnx", "status": "skipped", "reason": reason}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--onnx-tarball", default=None, help="reference model-bin.pt")
    ap.add_argument("--pack", default=None, help="existing converted weight pack")
    ap.add_argument("--ref-npz", default=None, help="precomputed reference-side npz")
    ap.add_argument("--save-ref", default=None, help="write reference-side npz here")
    ap.add_argument("--name-map", default=None, help="JSON name_map for conversion")
    ap.add_argument("--text", default="Xin chào Việt Nam.")
    ap.add_argument("--atol", type=float, default=1e-2)
    ap.add_argument(
        "--cpu",
        action="store_true",
        help="force the engine side onto the CPU backend (fixture "
        "rehearsals)",
    )
    ap.add_argument(
        "--precision-drift",
        default=None,
        metavar="N1,N2,...",
        help="instead of the golden gate, measure bf16-serving vs f32 mel "
        "drift per frame bucket on --pack (no ONNX side needed)",
    )
    ap.add_argument(
        "--cfg-cache-sweep",
        default=None,
        metavar="K1,K2,...",
        help="instead of the golden gate, price the CFG cache: run the "
        "latent pipeline at each nfe_uncond_interval (e.g. 1,2,4) from the "
        "same noise and print mel drift vs exact + step-time speedup",
    )
    ap.add_argument(
        "--deep-cache-sweep",
        default=None,
        metavar="R1:J1,R2:J2,...",
        help="instead of the golden gate, price the deep-block cache: run "
        "the latent pipeline at each (interval r, shallow blocks j) pair "
        "(e.g. 1:7,2:7,2:11) from the same noise and print mel drift vs "
        "exact + step-time speedup",
    )
    ap.add_argument(
        "--serving-precision",
        action="store_true",
        help="run the engine side with the pack's serving dtypes (bf16 compute, "
        "f16 transfer) instead of the default f32 numerics mode. The gate "
        "defaults to f32 so it measures CONVERSION correctness; the "
        "serving-precision drift on random weights sits near the gate — "
        "report both when qualifying real weights.",
    )
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    if args.precision_drift:
        if not args.pack:
            return _skip("--precision-drift needs --pack")
        frames = tuple(int(x) for x in args.precision_drift.split(","))
        print(json.dumps(precision_drift(args.pack, frames=frames)))
        return 0

    # -- acquire reference-side arrays ---------------------------------------
    if args.ref_npz:
        with np.load(args.ref_npz, allow_pickle=False) as z:
            ref = {k: z[k] for k in z.files}
    else:
        if not args.onnx_tarball:
            return _skip("no --onnx-tarball and no --ref-npz (tarball needs network)")
        from vietvoice_tts_tpu.models.onnx_eval import UnsupportedOp

        try:
            ref = reference_side(args.onnx_tarball, args.text)
        except UnsupportedOp as e:
            return _skip(
                f"graphs use op '{e}' outside the built-in evaluator's subset "
                "and onnxruntime is not installed — run the reference side "
                "elsewhere with --save-ref and pass --ref-npz here"
            )
        if args.save_ref:
            np.savez(
                args.save_ref,
                **{k: np.asarray(v) for k, v in ref.items() if k != "combined_text"},
                combined_text=np.asarray(str(ref["combined_text"])),
            )

    # -- acquire the weight pack ---------------------------------------------
    if args.pack:
        pack = Path(args.pack)
    else:
        if not args.onnx_tarball:
            return _skip("no --pack and no --onnx-tarball to convert")
        from vietvoice_tts_tpu.models.convert import convert_reference_tarball

        pack = Path(tempfile.mkdtemp(prefix="vv_golden_")) / "pack"
        name_map = (
            json.loads(Path(args.name_map).read_text()) if args.name_map else None
        )
        report = convert_reference_tarball(args.onnx_tarball, pack, name_map=name_map)
        weights = report.get("weights", {})
        if weights.get("skipped") or weights.get("unresolved"):
            return _skip(
                f"conversion incomplete: {weights.get('skipped') or weights['unresolved'][:5]}"
                " — extend the name map (see docs/CONVERSION_RUNBOOK.md)"
            )

    overrides = (
        {}
        if args.serving_precision
        else {"compute_dtype": "float32", "transfer_dtype": "float32"}
    )
    if args.cfg_cache_sweep:
        intervals = tuple(int(x) for x in args.cfg_cache_sweep.split(","))
        sweep = cfg_cache_sweep(pack, ref, intervals=intervals, **overrides)
        sweep["precision"] = "serving" if args.serving_precision else "float32"
        print(json.dumps(sweep))
        return 0
    if args.deep_cache_sweep:
        settings = tuple(
            tuple(int(v) for v in pair.split(":"))
            for pair in args.deep_cache_sweep.split(",")
        )
        sweep = deep_cache_sweep(pack, ref, settings=settings, **overrides)
        sweep["precision"] = "serving" if args.serving_precision else "float32"
        print(json.dumps(sweep))
        return 0
    result = engine_side(pack, ref, atol=args.atol, **overrides)
    result["precision"] = "serving" if args.serving_precision else "float32"
    print(json.dumps(result))
    return 0 if result["allclose"] else 1


if __name__ == "__main__":
    sys.exit(main())
