"""Golden-harness self-test: proves the engine-side comparison machinery works
before the real reference tarball exists (VERDICT r1 item #1).

The oracle is our own engine: we synthesize a "reference" npz (known noise →
known mel latent) and check golden.engine_side reproduces it to zero error, and
that a perturbed oracle fails the allclose gate."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import golden  # noqa: E402 — repo-root harness module

from tests.conftest import tiny_config  # noqa: E402


@pytest.fixture(scope="module")
def pack_and_core(tmp_path_factory):
    """A tiny materialized pack + EngineCore built from its metadata."""
    td = tmp_path_factory.mktemp("golden_pack")
    cfg = tiny_config(model_cache_dir=str(td))
    from vietvoice_tts_tpu.runtime.engine_core import EngineCore
    from vietvoice_tts_tpu.runtime.session import ModelSessionManager, config_from_pack

    mgr = ModelSessionManager(cfg)
    mgr.load_models()
    pack = Path(cfg.model_path)
    # Rebuild the config the way golden.py will — from pack metadata.
    cfg2 = config_from_pack(pack, nfe_step=cfg.nfe_step)
    core = EngineCore(cfg2, mgr.params, mgr.vocab_size)
    return pack, core, cfg2


def _oracle_ref(core, cfg, n_frames=128, ref_len=32, seed=0):
    """Build a reference-side dict whose ref_mel is OUR latent for known x0."""
    from vietvoice_tts_tpu.pipeline.text import TextProcessor

    rng = np.random.default_rng(seed)
    hop = cfg.hop_length
    audio = rng.uniform(-0.3, 0.3, ref_len * hop).astype(np.float32)
    wave = np.zeros((1, n_frames * hop), np.float32)
    wave[0, : len(audio)] = audio
    combined = "xin chào đây là giọng tham khảo. một câu để tổng hợp."
    tp = TextProcessor(str(Path(cfg.model_path) / "vocab.txt"))
    ids, _ = tp.encode_padded(combined, n_frames)
    x0 = rng.standard_normal((1, n_frames, cfg.n_mels)).astype(np.float32)
    latent = core.mel_latent_batch(
        wave,
        np.asarray([ref_len], np.int32),
        ids[None],
        np.asarray([n_frames], np.int32),
        x0=x0,
    )
    return {
        "audio": wave[0],
        "combined_text": combined,
        "noise": x0,
        "ref_mel": latent,
        "ref_signal_len": ref_len,
        "nfe_step": cfg.nfe_step,
    }


class TestNoiseInjection:
    def test_x0_is_deterministic_and_used(self, pack_and_core):
        _, core, cfg = pack_and_core
        ref = _oracle_ref(core, cfg)
        hop = cfg.hop_length
        n = ref["noise"].shape[1]
        wave = np.zeros((1, n * hop), np.float32)
        wave[0, : len(ref["audio"])] = ref["audio"]
        from vietvoice_tts_tpu.pipeline.text import TextProcessor

        tp = TextProcessor(str(Path(cfg.model_path) / "vocab.txt"))
        ids, _ = tp.encode_padded(str(ref["combined_text"]), n)
        args = (
            wave,
            np.asarray([ref["ref_signal_len"]], np.int32),
            ids[None],
            np.asarray([n], np.int32),
        )
        again = core.mel_latent_batch(*args, x0=ref["noise"])
        np.testing.assert_array_equal(again, ref["ref_mel"])
        seeded = core.mel_latent_batch(*args)  # internal noise path
        assert not np.allclose(seeded, ref["ref_mel"], atol=1e-3)


class TestGoldenTpuSide:
    def test_oracle_round_trip_is_zero_error(self, pack_and_core):
        pack, core, cfg = pack_and_core
        ref = _oracle_ref(core, cfg)
        result = golden.engine_side(pack, ref, atol=1e-2)
        assert result["status"] == "ok"
        assert result["allclose"] is True
        assert result["mel_mae"] < 1e-5, result
        assert result["frames"] == 128 and result["ref_frames"] == 32

    def test_perturbed_oracle_fails_gate(self, pack_and_core):
        pack, core, cfg = pack_and_core
        ref = _oracle_ref(core, cfg)
        ref = dict(ref, ref_mel=ref["ref_mel"] + 0.05)
        result = golden.engine_side(pack, ref, atol=1e-2)
        assert result["allclose"] is False
        assert result["mel_mae"] > 1e-2

    def test_channel_first_reference_layout_coerced(self, pack_and_core):
        """Reference tensors in [B, n_mels, N] layout are auto-transposed."""
        pack, core, cfg = pack_and_core
        ref = _oracle_ref(core, cfg)
        swapped = dict(
            ref,
            noise=np.swapaxes(ref["noise"], 1, 2),
            ref_mel=np.swapaxes(ref["ref_mel"], 1, 2),
        )
        result = golden.engine_side(pack, swapped, atol=1e-2)
        assert result["allclose"] is True and result["mel_mae"] < 1e-5

    def test_npz_round_trip(self, pack_and_core, tmp_path):
        """The --save-ref / --ref-npz file format preserves the comparison."""
        pack, core, cfg = pack_and_core
        ref = _oracle_ref(core, cfg)
        npz = tmp_path / "ref.npz"
        np.savez(
            npz,
            **{k: np.asarray(v) for k, v in ref.items() if k != "combined_text"},
            combined_text=np.asarray(str(ref["combined_text"])),
        )
        with np.load(npz, allow_pickle=False) as z:
            loaded = {k: z[k] for k in z.files}
        result = golden.engine_side(pack, loaded, atol=1e-2)
        assert result["allclose"] is True and result["mel_mae"] < 1e-5


class TestCfgCachePrice:
    def test_sweep_reports_drift_and_timing(self, pack_and_core):
        """Round-3 verdict #5: the CFG-cache knob's quality cost must be a
        reported NUMBER per interval (drift vs exact), not an assertion —
        acceptance is a real-weights decision. k=1 must be exactly the
        baseline (zero drift)."""
        pack, core, cfg = pack_and_core
        ref = _oracle_ref(core, cfg)
        report = golden.cfg_cache_sweep(
            pack, ref, intervals=(1, 2), repeats=1
        )
        assert report["metric"] == "cfg_cache_price"
        rows = {r["uncond_interval"]: r for r in report["rows"]}
        assert set(rows) == {1, 2}
        assert rows[1]["mel_mae_vs_exact"] == 0.0
        for r in rows.values():
            for key in (
                "mel_mae_vs_exact",
                "mel_max_abs_vs_exact",
                "mel_mae_vs_onnx",
                "latent_ms",
                "speedup_vs_exact",
            ):
                assert key in r and r[key] is not None
        # k=2 skips uncond refreshes → its latent differs from exact (the
        # drift is nonzero on any nontrivial weights); its magnitude is
        # informational, not gated.
        assert rows[2]["mel_mae_vs_exact"] > 0.0


class TestPrecisionDrift:
    def test_reports_per_bucket_drift(self, pack_and_core):
        """Round-3 verdict #9: serving-precision drift is a recorded number
        per bucket. On the tiny pack the serving default equals the tiny
        config only in dtype policy; the structure (and f32≈0 sanity) is
        what's asserted here — full-size numbers live in the runbook."""
        pack, _core, _cfg = pack_and_core
        report = golden.precision_drift(pack, frames=(128,), ref_frames=32)
        assert report["metric"] == "serving_precision_drift"
        (row,) = report["rows"]
        assert row["frames"] == 128
        assert row["mel_mae"] >= 0.0
        assert row["mel_max_abs"] >= row["mel_mae"]
        assert row["rel_mae"] is not None
