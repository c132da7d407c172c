"""Deterministic initialization.

Counterpart of the reference's ``vietvoicetts/deterministic.py:15-57`` (which
freezes ``random``, ``np.random``, ``ort.set_seed`` and ``PYTHONHASHSEED`` to
9527 and auto-runs on import). Here determinism is structural: all sampling
noise flows from an explicit ``jax.random`` key derived from the seed, so
synthesis is bit-reproducible per (seed, shapes, device count) without global
state, for one compiled program. On the GPU, XLA autotunes each program's
GEMM kernels when it compiles, so a fresh compile (another process with a
cold compile cache) may round differently. We still freeze the host-side
RNGs for any numpy/python randomness in tests and data prep.
"""

from __future__ import annotations

import os
import random

import numpy as np

DETERMINISTIC_SEED = 9527


def freeze_all_seeds(seed: int = DETERMINISTIC_SEED) -> None:
    """Freeze host RNGs; JAX keys are derived explicitly from the same seed."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def root_key(seed: int = DETERMINISTIC_SEED):
    """The root JAX PRNG key all sampler noise is folded from."""
    import jax

    return jax.random.PRNGKey(seed)


def setup_deterministic_tts(seed: int = DETERMINISTIC_SEED) -> None:
    """Full deterministic setup (reference deterministic.py:36-54). The
    reference's CUDA/cuBLAS environment pins have no counterpart here: the
    synthesis path is checked for byte-identical repeats on the GPU
    (``chip_smoke.py``)."""
    freeze_all_seeds(seed)


# Auto-initialize on import, matching reference deterministic.py:57.
freeze_all_seeds()
