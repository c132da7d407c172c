"""Flow-matching ODE sampler: the reference's Python NFE loop, fused.

The reference advances the ODE with 31 sequential ``session.run`` calls,
bouncing the full mel latent through host numpy every step
(``/root/reference/vietvoicetts/core/tts_engine.py:148-174``). Here the
whole solve is ONE ``lax.scan`` inside the jitted chunk program:

- **Sway-warped time grid** (F5 recipe): t ← t + s·(cos(πt/2) − 1 + t),
  spending more steps near t=0 where the field curves hardest.
- **CFG as a doubled batch**: cond and uncond branches run as one [2B]
  forward per step — one set of matmuls instead of two.
- **Text embedding hoisted**: character features don't depend on (x, t),
  so both branches' embeddings are computed once outside the scan.
- **Per-row seeded noise**: each utterance's initial noise derives from
  fold_in(key, row_seed), making output independent of batch composition
  (the batcher can coalesce requests invisibly). On the GPU, programs of
  different batch sizes may pick different GEMM kernels, so a row can
  differ from its one-row run by rounding (tens of int16 steps).
- ``fuse_nfe`` maps to ``lax.scan(..., unroll=fuse_nfe)`` — the same knob
  as the reference's fused-step count (``core/model_config.py:30``) but as
  a compiler unroll factor.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .dit import (
    DiTConfig,
    dit_forward_embedded,
    dit_text_embed,
    dit_time_modulations,
)


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    nfe_step: int = 32
    fuse_nfe: int = 1
    cfg_strength: float = 2.0
    sway_sampling_coef: float = -1.0
    # CFG caching (opt-in): refresh the unconditional velocity only every
    # k-th eval; between refreshes the cond-only forward runs at batch B
    # instead of the CFG-doubled 2B and reuses the cached uncond velocity.
    # 1 = exact reference semantics. With uncond_interval > 1, fuse_nfe
    # unrolls the inner cond-only scan (segments stay rolled).
    uncond_interval: int = 1
    # Deep-block caching (opt-in, TeaCache/Δ-DiT family): every r-th eval
    # runs all ``depth`` DiT blocks and records the deep trunk's residual
    # contribution (h_L − h_j); the r−1 evals in between run only the
    # first ``deep_cache_blocks`` blocks on the fresh input and reuse the
    # cached deep contribution — the deep residual drifts slowly between
    # adjacent flow times while the shallow blocks track the fast-changing
    # x_t. 1 = exact. Mutually exclusive with uncond_interval > 1 (the two
    # caches would interact unpredictably; pick one after pricing both).
    deep_cache_interval: int = 1
    deep_cache_blocks: int = 7


def sway_time_grid(cfg: SamplerConfig) -> jnp.ndarray:
    """Monotone [0, 1] grid of nfe_step points (nfe_step−1 intervals),
    sway-warped.

    Matches the reference's NFE semantics: its loop runs
    ``range(0, nfe_step-1, fuse_nfe)`` — nfe_step−1 velocity evaluations
    over nfe_step grid points (``core/tts_engine.py:157``)."""
    t = jnp.linspace(0.0, 1.0, cfg.nfe_step, dtype=jnp.float32)
    s = cfg.sway_sampling_coef
    if s:
        t = t + s * (jnp.cos(jnp.pi / 2.0 * t) - 1.0 + t)
    return t


def flow_matching_sample(
    params,
    dit_cfg: DiTConfig,
    cfg: SamplerConfig,
    key: jax.Array,
    cond: jnp.ndarray,  # [B, N, n_mels] reference-mel conditioning
    text_ids: jnp.ndarray,  # [B, N] int32, -1 padded
    mask: jnp.ndarray,  # [B, N] bool
    row_seeds: jnp.ndarray,  # [B] uint32 per-utterance seeds
    x0: jnp.ndarray | None = None,  # [B, N, n_mels] external initial noise
) -> jnp.ndarray:
    """Integrate the learned velocity field from noise to mel latent.

    ``x0`` overrides the per-row seeded noise — the golden-numerics harness
    feeds the *reference's* preprocess-graph noise here, since ORT's RNG is
    not reproducible from ``jax.random`` (SURVEY §7 hard part (c); reference
    noise tensor: ``core/tts_engine.py:228-230`` output 0).

    Returns [B, N, n_mels] float32.
    """
    b, n, m = cond.shape

    if x0 is not None:
        x = x0.astype(jnp.float32)
    else:
        # Per-row noise: independent of batch composition.
        row_keys = jax.vmap(lambda s: jax.random.fold_in(key, s))(
            row_seeds.astype(jnp.uint32)
        )
        x = jax.vmap(lambda k: jax.random.normal(k, (n, m), jnp.float32))(row_keys)

    # Doubled-batch CFG inputs, fixed across steps.
    cond2 = jnp.concatenate([cond, jnp.zeros_like(cond)], axis=0)
    mask2 = jnp.concatenate([mask, mask], axis=0)
    text2 = jnp.concatenate([text_ids, jnp.full_like(text_ids, -1)], axis=0)
    text_emb2 = dit_text_embed(params, dit_cfg, text2)  # hoisted out of the scan

    t_grid = sway_time_grid(cfg)
    t_starts, dts = t_grid[:-1], jnp.diff(t_grid)

    # AdaLN modulations for EVERY step, hoisted before the scan: t is shared
    # by all rows (cond and uncond alike), and the grid is static — so the
    # ada weight stack is read once per solve, not once per step
    # (dit_time_modulations). Shapes: [S, depth, 6d], [S, 2d]; the batch
    # axis broadcasts (B' = 1).
    mods_all, fmod_all = dit_time_modulations(params, dit_cfg, t_starts)

    def cfg_combine(v_cond, v_uncond):
        return v_cond + cfg.cfg_strength * (v_cond - v_uncond)

    def full_eval(x, t_cur, mod, fmod):
        """CFG-doubled forward → (v_cond, v_uncond)."""
        x2 = jnp.concatenate([x, x], axis=0)
        tb = jnp.full((2 * b,), t_cur, jnp.float32)
        v2 = dit_forward_embedded(
            params, dit_cfg, x2, cond2, text_emb2, tb, mask2,
            time_mod=(mod[:, None], fmod[None]),
        )
        return v2[:b], v2[b:]

    k = max(1, cfg.uncond_interval)
    r = max(1, cfg.deep_cache_interval)
    if k > 1 and r > 1:
        raise ValueError(
            "uncond_interval and deep_cache_interval are mutually exclusive "
            "— price both (golden.py) and enable at most one"
        )
    if k == 1 and r == 1:

        def euler_step(x, step):
            t_cur, dt, mod, fmod = step
            v_cond, v_uncond = full_eval(x, t_cur, mod, fmod)
            return x + dt * cfg_combine(v_cond, v_uncond), None

        x, _ = jax.lax.scan(
            euler_step,
            x,
            (t_starts, dts, mods_all, fmod_all),
            unroll=max(1, cfg.fuse_nfe),
        )
        return x

    if r > 1:
        # Deep-block caching: scan over segments of r evals. The first eval
        # of each segment runs the full depth and records the deep trunk's
        # residual contribution; the r−1 evals after it run only the first
        # ``deep_cache_blocks`` blocks and reuse that contribution. The
        # cache never crosses a segment boundary, so the carry is x alone.
        # Eval count pads up to whole segments with dt=0 identity steps.
        j = int(cfg.deep_cache_blocks)
        n_evals = int(t_starts.shape[0])
        n_seg = -(-n_evals // r)
        pad = n_seg * r - n_evals
        t_seg = jnp.pad(t_starts, (0, pad)).reshape(n_seg, r)
        dt_seg = jnp.pad(dts, (0, pad)).reshape(n_seg, r)
        mod_seg = jnp.pad(mods_all, ((0, pad), (0, 0), (0, 0))).reshape(
            n_seg, r, *mods_all.shape[1:]
        )
        fmod_seg = jnp.pad(fmod_all, ((0, pad), (0, 0))).reshape(
            n_seg, r, fmod_all.shape[1]
        )

        # Pre-slice the stacked block weights OUTSIDE the segment scan —
        # sliced inside the scanned body, XLA re-materializes the weight
        # copies every iteration.
        from .dit import scanned_blocks

        blocks_scan = scanned_blocks(params)
        presplit = (
            jax.tree.map(lambda a: a[:j], blocks_scan),
            jax.tree.map(lambda a: a[j:], blocks_scan),
        )

        def eval2(x, t_cur, mod, fmod, deep_state=None, record=False):
            x2 = jnp.concatenate([x, x], axis=0)
            tb = jnp.full((2 * b,), t_cur, jnp.float32)
            return dit_forward_embedded(
                params, dit_cfg, x2, cond2, text_emb2, tb, mask2,
                time_mod=(mod[:, None], fmod[None]),
                shallow_blocks=j,
                deep_state=deep_state,
                return_deep_state=record,
                presplit_blocks=presplit,
            )

        def segment(x, seg):
            ts, dtss, mods, fmods = seg
            v2, deep = eval2(x, ts[0], mods[0], fmods[0], record=True)
            x = x + dtss[0] * cfg_combine(v2[:b], v2[b:])

            def inner(x, step):
                t_cur, dt, mod, fmod = step
                v2s = eval2(x, t_cur, mod, fmod, deep_state=deep)
                return x + dt * cfg_combine(v2s[:b], v2s[b:]), None

            x, _ = jax.lax.scan(
                inner,
                x,
                (ts[1:], dtss[1:], mods[1:], fmods[1:]),
                unroll=max(1, cfg.fuse_nfe),
            )
            return x, None

        x, _ = jax.lax.scan(segment, x, (t_seg, dt_seg, mod_seg, fmod_seg))
        return x

    # CFG caching: scan over segments of k evals. Each segment refreshes
    # the uncond velocity with one CFG-doubled forward, then runs k−1
    # cond-only forwards (batch B, not 2B) against the cached uncond —
    # cutting DiT compute by (k−1)/(2k). The eval count is padded up to a
    # whole number of segments with dt=0 steps (x += 0·v, an identity).
    n_evals = int(t_starts.shape[0])
    n_seg = -(-n_evals // k)
    pad = n_seg * k - n_evals
    t_seg = jnp.pad(t_starts, (0, pad)).reshape(n_seg, k)
    dt_seg = jnp.pad(dts, (0, pad)).reshape(n_seg, k)
    # Pad steps are identities (dt = 0), so zero modulations are safe.
    mod_seg = jnp.pad(mods_all, ((0, pad), (0, 0), (0, 0))).reshape(
        n_seg, k, *mods_all.shape[1:]
    )
    fmod_seg = jnp.pad(fmod_all, ((0, pad), (0, 0))).reshape(
        n_seg, k, fmod_all.shape[1]
    )
    cond1 = cond2[:b]
    text_emb1 = text_emb2[:b]

    def cond_eval(x, t_cur, mod, fmod):
        tb = jnp.full((b,), t_cur, jnp.float32)
        return dit_forward_embedded(
            params, dit_cfg, x, cond1, text_emb1, tb, mask,
            time_mod=(mod[:, None], fmod[None]),
        )

    def segment(x, seg):
        ts, dtss, mods, fmods = seg
        v_cond, v_uncond = full_eval(x, ts[0], mods[0], fmods[0])
        x = x + dtss[0] * cfg_combine(v_cond, v_uncond)

        def inner(x, step):
            t_cur, dt, mod, fmod = step
            v_c = cond_eval(x, t_cur, mod, fmod)
            return x + dt * cfg_combine(v_c, v_uncond), None

        x, _ = jax.lax.scan(
            inner,
            x,
            (ts[1:], dtss[1:], mods[1:], fmods[1:]),
            unroll=max(1, cfg.fuse_nfe),
        )
        return x, None

    # fuse_nfe unrolls the inner cond-only scan so the fused-step knob keeps
    # its meaning on the CFG-cache path; the segment scan stays rolled (an
    # unrolled segment would duplicate the full CFG-doubled body k× in HLO).
    x, _ = jax.lax.scan(segment, x, (t_seg, dt_seg, mod_seg, fmod_seg))
    return x
