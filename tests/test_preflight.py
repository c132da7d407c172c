"""Conversion-day preflight checks (models/preflight.py).

Round-3 verdict #1: first contact with the real ``model-bin.pt`` must fail
in seconds with a checklist, not 40 minutes into conversion. These tests run
the preflight against the F5-export-shaped fixture (clean pass) and against
deliberately-hostile variants: an op outside the numpy evaluator's registry,
a stale/renamed name-map entry, an architecture outside the fused kernel's
envelope, and a missing graph.
"""

import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest

from vietvoice_tts_tpu.models import onnx_pb as ox
from vietvoice_tts_tpu.models.f5_fixture import (
    FixtureSpec,
    build_name_map,
    write_fixture_tarball,
)
from vietvoice_tts_tpu.models.preflight import preflight_report

SPEC = FixtureSpec(
    dim=64, depth=2, heads=16, ff_mult=2, n_mels=20, text_dim=32,
    text_conv_layers=2, vocab_size=211, voc_dim=48, voc_inter=96,
    voc_layers=2, nfe_step=8,
)


@pytest.fixture(scope="module")
def fixture_tar(tmp_path_factory):
    root = tmp_path_factory.mktemp("preflight")
    tar, name_map, _params = write_fixture_tarball(
        root / "model-bin.pt", SPEC, seed=5, ref_seconds=0.5
    )
    return tar, name_map


def _retar(src, dst, replace=None, drop=()):
    """Copy a tarball, replacing/dropping members by name."""
    replace = replace or {}
    with tarfile.open(src) as tin, tarfile.open(dst, "w") as tout:
        for m in tin.getmembers():
            if not m.isfile() or m.name in drop:
                continue
            data = tin.extractfile(m).read()
            if m.name in replace:
                data = replace[m.name]
            info = tarfile.TarInfo(m.name)
            info.size = len(data)
            tout.addfile(info, io.BytesIO(data))
    return dst


class TestCleanFixture:
    def test_clean_fixture_is_ok(self, fixture_tar):
        tar, name_map = fixture_tar
        report = preflight_report(tar, name_map=name_map)
        assert report["ok"], report["blockers"]
        assert report["blockers"] == []
        assert report["graphs_found"] == ["decode", "preprocess", "transformer"]
        assert report["vocab_size"] == SPEC.vocab_size

    def test_every_graph_op_is_in_evaluator_registry(self, fixture_tar):
        tar, name_map = fixture_tar
        report = preflight_report(tar, name_map=name_map)
        for stem, entry in report["op_coverage"].items():
            assert entry["unsupported_ops"] == [], stem
            assert entry["num_nodes"] > 0

    def test_name_map_resolves_every_leaf(self, fixture_tar):
        tar, name_map = fixture_tar
        report = preflight_report(tar, name_map=name_map)
        w = report["weights"]
        assert w["unresolved_leaves"] == []
        assert w["resolved_by_map"] + w["resolved_by_heuristic"] == w["leaves_total"]
        assert w["resolved_by_map"] > 0
        assert w["name_map_stale_entries"] == []

    def test_auto_discovers_sibling_name_map(self, fixture_tar):
        """name_map=None must pick up `<tarball>.name_map.json` — the
        zero-flag invocation that actually gets typed on conversion day."""
        tar, name_map = fixture_tar
        sib = Path(str(tar)).with_suffix(".name_map.json")
        sib.write_text(json.dumps(name_map))
        try:
            report = preflight_report(tar)
            assert report["ok"], report["blockers"]
            assert report["weights"]["name_map_source"] == str(sib)
            assert report["weights"]["resolved_by_map"] > 0
        finally:
            sib.unlink()

    def test_architecture_facts_and_kernel_note(self, fixture_tar):
        tar, name_map = fixture_tar
        report = preflight_report(tar, name_map=name_map)
        arch = report["architecture"]
        assert arch["conflicts"] == {}
        assert arch["facts"]["heads"] == 16
        assert arch["config"]["dit_heads"] == 16
        # head_dim = 64/16 = 4 on the tiny spec → outside the fused kernel.
        assert any("XLA path" in n for n in arch["notes"])


class TestHostileVariants:
    def test_unknown_op_is_a_blocker(self, fixture_tar, tmp_path):
        """A graph op missing from onnx_eval._OPS must be reported up front
        (it would otherwise abort the golden gate mid-run)."""
        tar, name_map = fixture_tar
        F32 = 1
        hostile_decode = ox.make_model(
            ox.make_graph(
                "decode",
                nodes=[
                    ox.make_node("Resize", ["noise", "roi", "scales"], ["up"]),
                    ox.make_node("ScatterND", ["up", "idx", "upd"], ["wav"]),
                ],
                initializers=[
                    ox.make_tensor("roi", np.zeros(4, np.float32)),
                    ox.make_tensor("scales", np.ones(2, np.float32)),
                    ox.make_tensor("idx", np.zeros((1, 1), np.int64)),
                    ox.make_tensor("upd", np.zeros((1,), np.float32)),
                ],
                inputs=[
                    ox.make_value_info("noise", F32, [1, "n", SPEC.n_mels]),
                    ox.make_value_info("ref_signal_len", 7, [1]),
                ],
                outputs=[ox.make_value_info("wav", F32, [1, "t"])],
            )
        )
        bad = _retar(
            tar, tmp_path / "bad-op.pt", replace={"decode.onnx": hostile_decode}
        )
        report = preflight_report(bad, name_map=name_map)
        assert not report["ok"]
        assert set(report["op_coverage"]["decode"]["unsupported_ops"]) == {
            "Resize",
            "ScatterND",
        }
        assert any("Resize" in b and "UnsupportedOp" in b for b in report["blockers"])

    def test_stale_explicit_name_map_entry_blocks(self, fixture_tar):
        """An explicit map entry naming a nonexistent initializer must mark
        its leaf unresolved (the escape hatch fails loudly)."""
        tar, name_map = fixture_tar
        broken = dict(name_map)
        leaf = next(iter(broken))
        broken[leaf] = {"name": "transformer.RENAMED.weight", "transpose": True}
        report = preflight_report(tar, name_map=broken)
        stale = report["weights"]["name_map_stale_entries"]
        assert leaf in stale
        # The leaf may still resolve by heuristics; if not, it must block.
        if leaf in report["weights"]["unresolved_leaves"]:
            assert not report["ok"]

    def test_stale_auto_map_entry_falls_back_to_heuristics(self, fixture_tar):
        """A stale entry in the AUTO-discovered sibling map is filtered (the
        heuristics take over) and surfaces as a warning, not a blocker —
        convert.py:518-524 semantics."""
        tar, name_map = fixture_tar
        broken = dict(name_map)
        # Rename an entry that heuristics can definitely recover: a
        # depth-stacked unique-shape family.
        leaf = next(iter(broken))
        broken[leaf] = {"name": "transformer.RENAMED.weight"}
        sib = Path(str(tar)).with_suffix(".name_map.json")
        sib.write_text(json.dumps(broken))
        try:
            report = preflight_report(tar)
            w = report["weights"]
            assert leaf in w["name_map_stale_entries"]
            assert any("stale" in x for x in report["warnings"])
        finally:
            sib.unlink()

    def test_missing_graph_blocks(self, fixture_tar, tmp_path):
        tar, name_map = fixture_tar
        bad = _retar(tar, tmp_path / "no-transformer.pt", drop=("transformer.onnx",))
        report = preflight_report(bad, name_map=name_map)
        assert not report["ok"]
        assert any("transformer.onnx missing" in b for b in report["blockers"])

    def test_missing_vocab_blocks(self, fixture_tar, tmp_path):
        tar, name_map = fixture_tar
        bad = _retar(tar, tmp_path / "no-vocab.pt", drop=("vocab.txt",))
        report = preflight_report(bad, name_map=name_map)
        assert not report["ok"]
        assert any("vocab.txt missing" in b for b in report["blockers"])

    def test_kernel_friendly_head_shape_is_noted(self, tmp_path):
        """A head_dim inside cuDNN's envelope (a multiple of 8, at most 128)
        gets the fused-attention note instead of the fallback note."""
        spec = FixtureSpec(
            dim=128, depth=2, heads=2, ff_mult=2, n_mels=20, text_dim=32,
            text_conv_layers=2, vocab_size=211, voc_dim=48, voc_inter=96,
            voc_layers=2, nfe_step=8,
        )  # head_dim = 64 → cuDNN fused attention applies
        tar, name_map, _ = write_fixture_tarball(
            tmp_path / "k.pt", spec, seed=6, ref_seconds=0.4
        )
        report = preflight_report(tar, name_map=name_map)
        arch = report["architecture"]
        assert any("cuDNN fused attention applies" in n for n in arch["notes"])
