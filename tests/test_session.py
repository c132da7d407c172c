"""Weight-pack session manager tests — mirrors reference coverage
(``/root/reference/tests/test_model_session_manager.py``) plus pack
materialization/reload determinism and the catalog APIs."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import tiny_config
from vietvoice_tts_tpu.runtime.serialization import PARAMS_FILE, load_params, save_params
from vietvoice_tts_tpu.runtime.session import ModelSessionManager


class TestPack:
    def test_pack_layout(self, tiny_pack_dir):
        pack = Path(tiny_pack_dir) / "vietvoice-tpu-v1"
        assert (pack / PARAMS_FILE).exists()
        assert (pack / "vocab.txt").exists()
        assert (pack / "audio_metadata.json").exists()
        assert (pack / "model_meta.json").exists()
        assert list((pack / "audios").glob("*.wav"))
        # CSV mirror for the reference_samples catalog API.
        assert (Path(tiny_pack_dir) / "reference_samples.csv").exists()

    def test_catalog_covers_all_tags(self, tiny_pack_dir):
        meta = json.loads(
            (Path(tiny_pack_dir) / "vietvoice-tpu-v1" / "audio_metadata.json").read_text()
        )
        from vietvoice_tts_tpu.config import MODEL_AREA, MODEL_EMOTION, MODEL_GENDER

        combos = {(s["gender"], s["area"], s["emotion"]) for s in meta}
        assert len(combos) == len(MODEL_GENDER) * len(MODEL_AREA) * len(MODEL_EMOTION)

    def test_reload_is_identical(self, tiny_pack_dir):
        mgr = ModelSessionManager(tiny_config(model_cache_dir=tiny_pack_dir))
        mgr.load_models()
        mgr2 = ModelSessionManager(tiny_config(model_cache_dir=tiny_pack_dir))
        mgr2.load_models()
        a = mgr.params["dit"]["input_proj"]["w"]
        b = mgr2.params["dit"]["input_proj"]["w"]
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_materialization_deterministic(self, temp_dir):
        """Same seed → bit-identical params across fresh packs."""
        import jax

        cfg_a = tiny_config(model_cache_dir=f"{temp_dir}/a")
        cfg_b = tiny_config(model_cache_dir=f"{temp_dir}/b")
        ma, mb = ModelSessionManager(cfg_a), ModelSessionManager(cfg_b)
        ma.load_models()
        mb.load_models()
        for leaf_a, leaf_b in zip(
            jax.tree.leaves(ma.params), jax.tree.leaves(mb.params)
        ):
            np.testing.assert_array_equal(np.asarray(leaf_a), np.asarray(leaf_b))


class TestPackWithoutParams:
    @pytest.mark.parametrize(
        "legacy, match",
        [(True, "params.msgpack.*convert.py"), (False, "refusing to materialize")],
    )
    def test_refused_and_left_untouched(self, tiny_pack_dir, temp_dir, legacy, match):
        """A pack dir without ``params.npz`` (e.g. one converted to the old
        flax-msgpack format) is refused, never overwritten by a synthetic one,
        even though synthetic packs are allowed."""
        import shutil

        src = Path(tiny_config(model_cache_dir=tiny_pack_dir).model_path)
        cfg = tiny_config(model_cache_dir=temp_dir, allow_synthetic_pack=True)
        pack = Path(cfg.model_path)
        shutil.copytree(src, pack)
        (pack / PARAMS_FILE).unlink()
        if legacy:
            (pack / "params.msgpack").write_bytes(b"\x81\xa3dit\x80")
        meta = json.loads((pack / "model_meta.json").read_text())
        meta.update(synthetic=False, converted_from="reference.tar.gz")
        (pack / "model_meta.json").write_text(json.dumps(meta))
        before = {
            f: (pack / f).read_bytes()
            for f in ("vocab.txt", "model_meta.json", "audio_metadata.json")
        }
        clips = sorted(p.name for p in (pack / "audios").iterdir())

        with pytest.raises(RuntimeError, match=match):
            ModelSessionManager(cfg).load_models()

        assert not (pack / PARAMS_FILE).exists()
        assert {f: (pack / f).read_bytes() for f in before} == before
        assert sorted(p.name for p in (pack / "audios").iterdir()) == clips


class TestSerialization:
    def test_round_trip(self, temp_dir):
        params = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "n": {"b": np.ones(4)}}
        path = f"{temp_dir}/{PARAMS_FILE}"
        save_params(path, params)
        back = load_params(path)
        np.testing.assert_array_equal(back["a"], params["a"])
        np.testing.assert_array_equal(back["n"]["b"], params["n"]["b"])

    def test_round_trip_keeps_lists_and_dtypes(self, temp_dir):
        """Lists (``text_embed.blocks``, ``conv_pos``) stay lists in order;
        every leaf keeps its dtype and shape, bfloat16 included."""
        params = {
            "dit": {
                "text_embed": {
                    "blocks": [
                        {"pw1": {"w": np.full((2, 3), i, np.float32)}}
                        for i in range(11)
                    ]
                },
                "conv_pos": [
                    {"w": np.ones((3, 1, 4), jnp.bfloat16)},
                    {"b": np.arange(4, dtype=np.float16)},
                ],
                "steps": np.int32(7),
            },
            "vocoder": {"ids": np.arange(5, dtype=np.int64)},
        }
        path = f"{temp_dir}/{PARAMS_FILE}"
        save_params(path, params)
        back = load_params(path)
        assert jax.tree.structure(back) == jax.tree.structure(params)
        blocks = back["dit"]["text_embed"]["blocks"]
        assert isinstance(blocks, list) and isinstance(back["dit"]["conv_pos"], list)
        assert [float(b["pw1"]["w"][0, 0]) for b in blocks] == list(range(11))
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
            assert got.dtype == np.asarray(want).dtype
            np.testing.assert_array_equal(got, np.asarray(want))

    def test_unstorable_key_refused(self, temp_dir):
        with pytest.raises(ValueError, match="cannot be stored"):
            save_params(f"{temp_dir}/{PARAMS_FILE}", {"a/b": np.zeros(1)})


class TestSelectSample:
    @pytest.fixture
    def mgr(self, tiny_pack_dir):
        m = ModelSessionManager(tiny_config(model_cache_dir=tiny_pack_dir))
        m.load_models()
        return m

    def test_defaults_select_configured_voice(self, mgr):
        audio, text = mgr.select_sample()
        assert Path(audio).exists()
        assert text

    def test_explicit_filters(self, mgr):
        s = mgr.sample_metadata[3]
        audio, text = mgr.select_sample(
            gender=s["gender"], group=s["group"], area=s["area"], emotion=s["emotion"]
        )
        assert Path(audio).name == s["file_name"]
        assert text == s["text"]

    def test_invalid_filter_raises(self, mgr):
        for kwargs in (
            {"gender": "robot"},
            {"group": "podcast"},
            {"area": "western"},
            {"emotion": "bored"},
        ):
            with pytest.raises(ValueError):
                mgr.select_sample(**kwargs)

    def test_user_reference_passthrough(self, mgr, sample_wav):
        audio, text = mgr.select_sample(
            reference_audio=sample_wav, reference_text="chép lời"
        )
        assert audio == sample_wav
        assert text == "chép lời"

    def test_user_reference_missing_file(self, mgr):
        with pytest.raises(FileNotFoundError):
            mgr.select_sample(reference_audio="/nope.wav", reference_text="t")

    def test_cleanup_releases_params(self, mgr):
        mgr.cleanup()
        assert mgr.params is None


class TestSyntheticPackGate:
    def test_materialized_pack_is_marked_synthetic(self, tiny_pack_dir):
        import json
        from pathlib import Path

        from tests.conftest import tiny_config

        cfg = tiny_config(model_cache_dir=tiny_pack_dir)
        meta = json.loads((Path(cfg.model_path) / "model_meta.json").read_text())
        assert meta["synthetic"] is True

    def test_load_sets_is_synthetic(self, tiny_pack_dir):
        from tests.conftest import tiny_config
        from vietvoice_tts_tpu.runtime.session import ModelSessionManager

        mgr = ModelSessionManager(tiny_config(model_cache_dir=tiny_pack_dir))
        mgr.load_models()
        assert mgr.is_synthetic is True

    def test_refuses_to_materialize_when_gated(self, temp_dir):
        import pytest

        from tests.conftest import tiny_config
        from vietvoice_tts_tpu.runtime.session import ModelSessionManager

        cfg = tiny_config(model_cache_dir=temp_dir, allow_synthetic_pack=False)
        with pytest.raises(RuntimeError, match="synthetic"):
            ModelSessionManager(cfg).load_models()

    def test_refuses_to_load_synthetic_pack_when_gated(self, tiny_pack_dir):
        import pytest

        from tests.conftest import tiny_config
        from vietvoice_tts_tpu.runtime.session import ModelSessionManager

        cfg = tiny_config(
            model_cache_dir=tiny_pack_dir, allow_synthetic_pack=False
        )
        with pytest.raises(RuntimeError, match="synthetic"):
            ModelSessionManager(cfg).load_models()

    def test_pack_without_markers_counts_as_synthetic(self, tiny_pack_dir):
        """Packs predating the marker (no 'synthetic', no 'converted_from')
        must be treated as synthetic — only convert.py writes converted_from."""
        import json
        import shutil
        from pathlib import Path

        from tests.conftest import tiny_config

        src = Path(tiny_config(model_cache_dir=tiny_pack_dir).model_path)
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            cfg = tiny_config(model_cache_dir=td)
            dst = Path(cfg.model_path)
            shutil.copytree(src, dst)
            meta = json.loads((dst / "model_meta.json").read_text())
            meta.pop("synthetic", None)
            meta.pop("converted_from", None)
            (dst / "model_meta.json").write_text(json.dumps(meta))
            from vietvoice_tts_tpu.runtime.session import ModelSessionManager

            mgr = ModelSessionManager(cfg)
            mgr.load_models()
            assert mgr.is_synthetic is True
