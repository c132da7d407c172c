"""Checkpoint/resume (orbax) and ONNX-asset conversion tests."""

import json
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vietvoice_tts_tpu.models.convert import extract_assets, load_onnx_initializers
from vietvoice_tts_tpu.models.dit import DiTConfig, init_dit_params
from vietvoice_tts_tpu.training.checkpoint import CheckpointManager
from vietvoice_tts_tpu.training.train import TrainConfig, init_train_state

CFG = DiTConfig(
    dim=32, depth=1, heads=2, n_mels=8, text_dim=16, text_conv_layers=1,
    vocab_size=16, compute_dtype=jnp.float32,
)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, temp_dir):
        params = init_dit_params(0, CFG)
        opt_state = init_train_state(params, TrainConfig())
        mgr = CheckpointManager(temp_dir, save_interval_steps=1)
        assert mgr.save(0, params, opt_state, force=True)
        mgr.manager.wait_until_finished()
        p2, o2, step = mgr.restore()
        assert step == 0
        np.testing.assert_array_equal(
            np.asarray(params["input_proj"]["w"]), np.asarray(p2["input_proj"]["w"])
        )
        mgr.close()

    def test_latest_step_tracking(self, temp_dir):
        params = init_dit_params(0, CFG)
        opt_state = init_train_state(params, TrainConfig())
        mgr = CheckpointManager(temp_dir, save_interval_steps=1)
        mgr.save(0, params, opt_state, force=True)
        mgr.save(5, params, opt_state, force=True)
        mgr.manager.wait_until_finished()
        assert mgr.latest_step() == 5
        mgr.close()

    def test_restore_empty_raises(self, temp_dir):
        mgr = CheckpointManager(temp_dir)
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        mgr.close()

    def test_export_for_inference(self, temp_dir):
        from vietvoice_tts_tpu.runtime.serialization import PARAMS_FILE, load_params

        params = init_dit_params(0, CFG)
        mgr = CheckpointManager(temp_dir)
        mgr.export_for_inference(params, temp_dir)
        back = load_params(Path(temp_dir) / PARAMS_FILE)
        np.testing.assert_array_equal(
            np.asarray(params["final_proj"]["w"]), back["final_proj"]["w"]
        )
        mgr.close()


class TestConvert:
    def _make_tarball(self, temp_dir) -> Path:
        """Synthetic reference-layout tarball (model.py:73-123 layout)."""
        root = Path(temp_dir)
        (root / "cleaned_audios").mkdir()
        (root / "vocab.txt").write_text("a\nb\nc\n")
        (root / "audio_metadata.json").write_text(
            json.dumps([{"file_name": "x.wav", "gender": "female", "group":
                         "news", "area": "northern", "emotion": "neutral",
                         "text": "xin chào"}])
        )
        (root / "cleaned_audios" / "x.wav").write_bytes(b"RIFFfake")
        tar_path = root / "model-bin.pt"
        with tarfile.open(tar_path, "w") as tar:
            for name in ("vocab.txt", "audio_metadata.json", "cleaned_audios/x.wav"):
                tar.add(root / name, arcname=name)
        return tar_path

    def test_extract_assets(self, temp_dir):
        tar_path = self._make_tarball(temp_dir)
        pack = Path(temp_dir) / "pack"
        found = extract_assets(tar_path, pack)
        assert found["vocab"] and found["metadata"] and found["audios"] == 1
        assert (pack / "vocab.txt").read_text() == "a\nb\nc\n"
        assert (pack / "audios" / "x.wav").exists()

    def test_graph_load_without_graphs_is_empty(self, temp_dir):
        """A tarball with no .onnx members yields no initializers (the
        reader itself needs no external onnx package)."""
        tar_path = self._make_tarball(temp_dir)
        assert load_onnx_initializers(tar_path) == {}


class TestInitializerMapping:
    """Shape/stack/transpose-aware ONNX-initializer → pytree mapping."""

    def _template(self):
        return {
            "input_proj": {"w": np.zeros((8, 16), np.float32), "b": np.zeros(16, np.float32)},
            "blocks": {
                "qkv": {"w": np.zeros((3, 16, 48), np.float32), "b": np.zeros((3, 48), np.float32)},
            },
            "final": {"w": np.zeros((16, 6), np.float32)},
        }

    def test_exact_and_transposed_and_stacked(self):
        from vietvoice_tts_tpu.models.convert import map_initializers_to_params

        rng = np.random.default_rng(0)
        inits = {
            # torch-style [out, in] → must transpose to our [in, out]
            "proj.weight": rng.standard_normal((16, 8)).astype(np.float32),
            "proj.bias": rng.standard_normal(16).astype(np.float32),
            # per-layer qkv weights to stack (already [in, out] here)
            "blocks.0.qkv.weight": rng.standard_normal((16, 48)).astype(np.float32),
            "blocks.1.qkv.weight": rng.standard_normal((16, 48)).astype(np.float32),
            "blocks.2.qkv.weight": rng.standard_normal((16, 48)).astype(np.float32),
            "blocks.0.qkv.bias": rng.standard_normal(48).astype(np.float32),
            "blocks.1.qkv.bias": rng.standard_normal(48).astype(np.float32),
            "blocks.2.qkv.bias": rng.standard_normal(48).astype(np.float32),
            "head.weight": rng.standard_normal((6, 16)).astype(np.float32),
        }
        params, report = map_initializers_to_params(inits, self._template())
        assert report["unresolved"] == []
        np.testing.assert_array_equal(params["input_proj"]["w"], inits["proj.weight"].T)
        np.testing.assert_array_equal(
            params["blocks"]["qkv"]["w"][1], inits["blocks.1.qkv.weight"]
        )
        np.testing.assert_array_equal(
            params["blocks"]["qkv"]["b"][2], inits["blocks.2.qkv.bias"]
        )
        np.testing.assert_array_equal(params["final"]["w"], inits["head.weight"].T)

    def test_name_map_overrides_and_reports_unresolved(self):
        from vietvoice_tts_tpu.models.convert import map_initializers_to_params

        rng = np.random.default_rng(1)
        template = {
            "a": {"w": np.zeros((4, 4), np.float32)},
            "b": {"w": np.zeros((4, 4), np.float32)},
        }
        x = rng.standard_normal((4, 4)).astype(np.float32)
        y = rng.standard_normal((4, 4)).astype(np.float32)
        # Two same-shape candidates → ambiguous without a name map.
        params, report = map_initializers_to_params({"x": x, "y": y}, template)
        assert set(report["unresolved"]) == {"a.w", "b.w"}
        params, report = map_initializers_to_params(
            {"x": x, "y": y}, template, name_map={"a.w": "x", "b.w": "y"}
        )
        assert report["unresolved"] == []
        np.testing.assert_array_equal(params["a"]["w"], x)
        np.testing.assert_array_equal(params["b"]["w"], y)

    def test_maps_into_real_dit_template(self):
        """A synthetic per-layer initializer dump fills the real DiT tree."""
        from vietvoice_tts_tpu.models.convert import map_initializers_to_params
        from vietvoice_tts_tpu.models.dit import init_dit_params

        template = init_dit_params(0, CFG)
        rng = np.random.default_rng(2)
        inits = {}
        # Emit uniquely-shaped leaves as-is; depth-stacked leaves per layer.
        from vietvoice_tts_tpu.models.convert import _flatten

        for path, leaf in _flatten(template).items():
            a = np.asarray(leaf)
            if path.startswith("blocks.") and a.ndim >= 2:
                for i in range(a.shape[0]):
                    inits[f"transformer.{i}.{path}"] = rng.standard_normal(
                        a.shape[1:]
                    ).astype(np.float32)
            else:
                inits[f"g.{path}"] = rng.standard_normal(a.shape).astype(np.float32)
        name_map = {
            p: f"g.{p}"
            for p, leaf in _flatten(template).items()
            if not (p.startswith("blocks.") and np.asarray(leaf).ndim >= 2)
        }
        params, report = map_initializers_to_params(inits, template, name_map=name_map)
        assert report["unresolved"] == []
        np.testing.assert_array_equal(
            params["blocks"]["qkv"]["w"][0], inits["transformer.0.blocks.qkv.w"]
        )

    def test_convert_reference_tarball_assets_only(self, temp_dir):
        """A tarball without graphs still builds a loadable pack from
        assets + seeded weights, reported as skipped (and synthetic)."""
        from vietvoice_tts_tpu.models.convert import convert_reference_tarball
        from vietvoice_tts_tpu.runtime.serialization import PARAMS_FILE, load_params

        root = Path(temp_dir)
        (root / "cleaned_audios").mkdir()
        (root / "vocab.txt").write_text("a\nb\nc\nd\n")
        (root / "audio_metadata.json").write_text("[]")
        (root / "cleaned_audios" / "x.wav").write_bytes(b"RIFFfake")
        tar_path = root / "model-bin.pt"
        with tarfile.open(tar_path, "w") as tar:
            for name in ("vocab.txt", "audio_metadata.json", "cleaned_audios/x.wav"):
                tar.add(root / name, arcname=name)

        from tests.conftest import tiny_config

        cfg = tiny_config(model_cache_dir=str(root / "cache"))
        pack = root / "pack"
        report = convert_reference_tarball(tar_path, pack, config=cfg)
        assert report["assets"]["vocab"]
        assert "skipped" in report["weights"]
        params = load_params(pack / PARAMS_FILE)
        assert params["dit"]["text_embed"]["table"].shape[0] == 5  # 4 chars + filler
        meta = json.loads((pack / "model_meta.json").read_text())
        assert meta["vocab_size"] == 4
        assert meta["synthetic"] is True  # seeded weights remain → honest marker


class TestRealTarballShape:
    """extract_assets against the reference tarball's real layout: nested
    cleaned_audios/ paths, possibly under a top-level directory
    (core/model.py:206-210 reads members by exact nested name)."""

    def test_nested_paths_flatten(self, temp_dir):
        root = Path(temp_dir)
        deep = root / "pkg" / "cleaned_audios" / "female" / "north"
        deep.mkdir(parents=True)
        (root / "pkg").joinpath("vocab.txt").write_text("a\nb\n")
        (root / "pkg").joinpath("audio_metadata.json").write_text("[]")
        for i in range(3):
            (deep / f"clip_{i}.wav").write_bytes(b"RIFF" + bytes([i]))
        tar_path = root / "model-bin.pt"
        with tarfile.open(tar_path, "w") as tar:
            tar.add(root / "pkg", arcname="pkg")

        pack = root / "pack"
        found = extract_assets(tar_path, pack)
        assert found == {"vocab": True, "metadata": True, "audios": 3}
        assert sorted(p.name for p in (pack / "audios").iterdir()) == [
            "clip_0.wav", "clip_1.wav", "clip_2.wav",
        ]
