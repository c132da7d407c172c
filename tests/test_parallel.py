"""Mesh/sharding tests on the 8-device virtual CPU mesh: TP param layouts,
sharded inference parity with single-device, sharded train step, and the
driver's dryrun entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vietvoice_tts_tpu.models.dit import DiTConfig, dit_forward, init_dit_params
from vietvoice_tts_tpu.models.vocoder import VocoderConfig, init_vocoder_params
from vietvoice_tts_tpu.parallel.mesh import make_mesh, mesh_axis_sizes
from vietvoice_tts_tpu.parallel.sharding import (
    batch_sharding,
    param_pspecs,
    shard_params,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

DIT = DiTConfig(
    dim=128,
    depth=2,
    heads=8,
    ff_mult=2,
    n_mels=16,
    text_dim=64,
    text_conv_layers=1,
    vocab_size=32,
    compute_dtype=jnp.float32,
)
VOC = VocoderConfig(
    dim=64, intermediate_dim=128, num_layers=1, n_mels=16, n_fft=256, hop_length=64
)


class TestMesh:
    def test_shape(self):
        mesh = make_mesh(data=2, model=4)
        assert mesh_axis_sizes(mesh) == (2, 4)

    def test_bad_model_axis(self):
        with pytest.raises(ValueError):
            make_mesh(model=3)

    def test_default_data_axis(self):
        mesh = make_mesh(model=2)
        assert mesh_axis_sizes(mesh) == (len(jax.devices()) // 2, 2)


class TestShardings:
    def test_pspec_tree_matches_params(self):
        params = {"dit": init_dit_params(0, DIT), "vocoder": init_vocoder_params(1, VOC)}
        specs = param_pspecs(DIT, VOC)
        # Same tree structure — tree.map would raise otherwise.
        jax.tree.map(lambda a, b: None, params, specs,
                     is_leaf=lambda x: not isinstance(x, (dict, list)))

    def test_qkv_sharded_over_model_axis(self):
        mesh = make_mesh(data=2, model=4)
        params = {"dit": init_dit_params(0, DIT), "vocoder": init_vocoder_params(1, VOC)}
        sharded = shard_params(params, mesh, DIT, VOC)
        qkv = sharded["dit"]["blocks"]["qkv"]["w"]
        # Output dim split over 4 model shards (leading depth axis intact).
        shard_shapes = {s.data.shape for s in qkv.addressable_shards}
        assert shard_shapes == {(DIT.depth, DIT.dim, 3 * DIT.dim // 4)}

    def test_sharded_forward_matches_single_device(self):
        """TP+DP sharded DiT forward == unsharded forward (numerics)."""
        params = {"dit": init_dit_params(0, DIT), "vocoder": init_vocoder_params(1, VOC)}
        b, n = 4, 64
        rng = np.random.default_rng(0)
        x = rng.standard_normal((b, n, DIT.n_mels)).astype(np.float32)
        cond = np.zeros((b, n, DIT.n_mels), np.float32)
        text = np.full((b, n), 3, np.int32)
        t = np.full((b,), 0.3, np.float32)
        mask = np.ones((b, n), bool)

        ref = np.asarray(
            dit_forward(params["dit"], DIT, x, cond, text, t, mask)
        )

        mesh = make_mesh(data=2, model=4)
        sharded = shard_params(params, mesh, DIT, VOC)
        args = [
            jax.device_put(a, batch_sharding(mesh, np.asarray(a).ndim))
            for a in (x, cond, text, t, mask)
        ]
        fn = jax.jit(lambda p, *a: dit_forward(p, DIT, *a))
        out = np.asarray(fn(sharded["dit"], *args))
        np.testing.assert_allclose(out, ref, atol=2e-4)

    def test_dryrun_multichip(self):
        import __graft_entry__

        __graft_entry__.dryrun_multichip(8)


class TestUlyssesSequenceParallel:
    """Frame-axis sharded attention == single-device attention."""

    def _data(self, B=2, N=64, H=8, D=16):
        rng = np.random.default_rng(0)
        q, k, v = (
            rng.standard_normal((B, N, H, D)).astype(np.float32) for _ in range(3)
        )
        mask = np.ones((B, N), bool)
        mask[1, N // 2 :] = False
        return q, k, v, mask

    def test_matches_single_device(self):
        from vietvoice_tts_tpu.ops.attention import attention
        from vietvoice_tts_tpu.ops.rope import apply_rope, rope_tables
        from vietvoice_tts_tpu.parallel.sequence import (
            sequence_sharding,
            ulysses_attention,
        )

        B, N, H, D = 2, 64, 8, 16
        q, k, v, mask = self._data(B, N, H, D)
        cos, sin = rope_tables(N, D)

        # Single-device reference.
        qb = jnp.moveaxis(jnp.asarray(q), 1, 2)
        kb = jnp.moveaxis(jnp.asarray(k), 1, 2)
        vb = jnp.moveaxis(jnp.asarray(v), 1, 2)
        ref = np.moveaxis(
            np.asarray(
                attention(
                    apply_rope(qb, cos, sin), apply_rope(kb, cos, sin), vb,
                    jnp.asarray(mask),
                )
            ),
            1,
            2,
        )

        mesh = make_mesh(data=2, model=4)
        shard = sequence_sharding(mesh)
        qs, ks, vs = (
            jax.device_put(jnp.asarray(x), shard) for x in (q, k, v)
        )
        out = np.asarray(
            ulysses_attention(
                qs, ks, vs, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(mask),
                mesh=mesh,
            )
        )
        # Masked rows beyond valid length are undefined; compare valid region.
        np.testing.assert_allclose(out[0], ref[0], atol=2e-5)
        np.testing.assert_allclose(out[1, : N // 2], ref[1, : N // 2], atol=2e-5)

    def test_bf16_matches_single_device_packed_path(self):
        """In bf16, Ulysses and the single-device packed path share one
        rotate-then-attend step, so each valid row comes out bit-identical."""
        from vietvoice_tts_tpu.ops.attention import PLAIN, packed_rope_attention
        from vietvoice_tts_tpu.ops.rope import rope_tables
        from vietvoice_tts_tpu.parallel.sequence import (
            sequence_sharding,
            ulysses_attention,
        )

        B, N, H, D = 2, 64, 8, 16
        q, k, v, mask = self._data(B, N, H, D)
        q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        cos, sin = (jnp.asarray(t) for t in rope_tables(N, D))
        qkv = jnp.concatenate([x.reshape(B, N, H * D) for x in (q, k, v)], -1)
        ref = np.asarray(
            packed_rope_attention(qkv, cos, sin, jnp.asarray(mask), H, PLAIN),
            np.float32,
        ).reshape(B, N, H, D)

        mesh = make_mesh(data=2, model=4)
        shard = sequence_sharding(mesh)
        out = ulysses_attention(
            *(jax.device_put(x, shard) for x in (q, k, v)),
            cos, sin, jnp.asarray(mask), mesh=mesh,
        )
        assert out.dtype == jnp.bfloat16
        out = np.asarray(out, np.float32)
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1, : N // 2], ref[1, : N // 2])

    def test_rejects_indivisible_heads(self):
        from vietvoice_tts_tpu.ops.rope import rope_tables
        from vietvoice_tts_tpu.parallel.sequence import ulysses_attention

        mesh = make_mesh(data=2, model=4)
        q = jnp.zeros((1, 16, 6, 8))  # 6 heads not divisible by 4
        cos, sin = rope_tables(16, 8)
        with pytest.raises(ValueError):
            ulysses_attention(q, q, q, jnp.asarray(cos), jnp.asarray(sin),
                              jnp.ones((1, 16), bool), mesh=mesh)


class TestRingSequenceParallel:
    """ppermute ring attention == single-device attention (online softmax)."""

    def test_matches_single_device(self):
        from vietvoice_tts_tpu.ops.attention import attention
        from vietvoice_tts_tpu.ops.rope import apply_rope, rope_tables
        from vietvoice_tts_tpu.parallel.sequence import (
            ring_attention,
            sequence_sharding,
        )

        B, N, H, D = 2, 64, 6, 16  # 6 heads: Ulysses would reject sp=4
        rng = np.random.default_rng(3)
        q, k, v = (
            rng.standard_normal((B, N, H, D)).astype(np.float32) for _ in range(3)
        )
        mask = np.ones((B, N), bool)
        mask[1, 40:] = False
        cos, sin = rope_tables(N, D)

        qb = jnp.moveaxis(jnp.asarray(q), 1, 2)
        kb = jnp.moveaxis(jnp.asarray(k), 1, 2)
        vb = jnp.moveaxis(jnp.asarray(v), 1, 2)
        ref = np.moveaxis(
            np.asarray(
                attention(
                    apply_rope(qb, cos, sin), apply_rope(kb, cos, sin), vb,
                    jnp.asarray(mask),
                )
            ),
            1,
            2,
        )

        mesh = make_mesh(data=2, model=4)
        shard = sequence_sharding(mesh)
        qs, ks, vs = (jax.device_put(jnp.asarray(x), shard) for x in (q, k, v))
        out = np.asarray(
            ring_attention(
                qs, ks, vs, jnp.asarray(cos), jnp.asarray(sin),
                jnp.asarray(mask), mesh=mesh,
            )
        )
        np.testing.assert_allclose(out[0], ref[0], atol=2e-5)
        np.testing.assert_allclose(out[1, :40], ref[1, :40], atol=2e-5)

    def test_rejects_indivisible_frames(self):
        from vietvoice_tts_tpu.ops.rope import rope_tables
        from vietvoice_tts_tpu.parallel.sequence import ring_attention

        mesh = make_mesh(data=2, model=4)
        q = jnp.zeros((1, 18, 4, 8))  # 18 frames not divisible by 4
        cos, sin = rope_tables(18, 8)
        with pytest.raises(ValueError):
            ring_attention(q, q, q, jnp.asarray(cos), jnp.asarray(sin),
                           jnp.ones((1, 18), bool), mesh=mesh)


class TestSequenceParallelSampler:
    """SP wired end-to-end (VERDICT r1 #3): the full flow-matching sampler
    with frame-sharded activations matches the unsharded sampler."""

    def _sample_args(self, dit_cfg, b=2, n=64, seed=0):
        rng = np.random.default_rng(seed)
        cond = rng.standard_normal((b, n, dit_cfg.n_mels)).astype(np.float32) * 0.1
        text = np.full((b, n), 3, np.int32)
        text[:, n // 2 :] = -1
        mask = np.ones((b, n), bool)
        mask[1, n - 8 :] = False
        seeds = np.arange(b, dtype=np.uint32)
        return cond, text, mask, seeds

    def _run(self, dit_cfg, params):
        import dataclasses

        from vietvoice_tts_tpu.models.sampler import (
            SamplerConfig,
            flow_matching_sample,
        )

        scfg = SamplerConfig(nfe_step=4)
        cond, text, mask, seeds = self._sample_args(dit_cfg)
        key = jax.random.PRNGKey(0)
        return np.asarray(
            flow_matching_sample(
                params, dit_cfg, scfg, key,
                jnp.asarray(cond), jnp.asarray(text), jnp.asarray(mask),
                jnp.asarray(seeds),
            )
        )

    def test_ulysses_path_matches_unsharded(self):
        """heads (8) divide the model axis (4) → Ulysses."""
        import dataclasses

        params = init_dit_params(0, DIT)
        ref = self._run(DIT, params)
        mesh = make_mesh(data=2, model=4)
        sp_cfg = dataclasses.replace(
            DIT, seq_mesh=mesh, seq_axis="model", seq_batch_axis=None
        )
        out = self._run(sp_cfg, params)
        np.testing.assert_allclose(out, ref, atol=2e-4)

    def test_ring_path_matches_unsharded(self):
        """heads (6) do NOT divide the axis (4) → ppermute ring."""
        import dataclasses

        cfg6 = dataclasses.replace(DIT, heads=6, dim=96)
        params = init_dit_params(1, cfg6)
        ref = self._run(cfg6, params)
        mesh = make_mesh(data=2, model=4)
        sp_cfg = dataclasses.replace(cfg6, seq_mesh=mesh)
        out = self._run(sp_cfg, params)
        np.testing.assert_allclose(out, ref, atol=2e-4)

    def test_engine_core_sequence_parallel(self, tiny_pack_dir):
        """EngineCore with sequence_parallel=True produces the same audio as
        the single-device engine (int16 LSB tolerance)."""
        from tests.conftest import tiny_config
        from vietvoice_tts_tpu.runtime.engine_core import EngineCore
        from vietvoice_tts_tpu.runtime.session import ModelSessionManager

        cfg = tiny_config(model_cache_dir=tiny_pack_dir, sequence_parallel=True)
        mgr = ModelSessionManager(cfg)
        mgr.load_models()

        hop = cfg.hop_length
        rng = np.random.default_rng(0)
        wave = rng.uniform(-0.3, 0.3, (2, 128 * hop)).astype(np.float32)
        ref_len = np.array([16, 16], np.int32)
        total = np.array([100, 112], np.int32)
        ids = np.full((2, 128), 4, np.int32)

        solo = EngineCore(tiny_config(model_cache_dir=tiny_pack_dir), mgr.params,
                          mgr.vocab_size)
        ref = solo.synthesize_batch(wave, ref_len, ids, total, seed=np.arange(2, dtype=np.uint32))

        mesh = make_mesh(data=2, model=4)
        core = EngineCore(cfg, mgr.params, mgr.vocab_size, mesh=mesh)
        assert core.dit_cfg.seq_mesh is mesh
        out = core.synthesize_batch(wave, ref_len, ids, total, seed=np.arange(2, dtype=np.uint32))
        np.testing.assert_allclose(
            out.astype(np.int32), ref.astype(np.int32), atol=1
        )
