"""Device mesh construction for data × model parallel synthesis/training.

The reference has no distributed backend at all (SURVEY §2: single process,
sequential chunks; its only concurrency is a worker thread at
``/root/reference/vietvoicetts/api/tts_engine.py:79``). Here parallel scale
comes from a 2-D ``jax.sharding.Mesh``:

- ``data``  — utterance/chunk batches (and the serving loop's micro-batches);
- ``model`` — tensor parallelism for DiT heads/FFN and vocoder channels.

XLA lowers the resulting collectives to the device interconnect (NCCL on the
GPU); multi-host process groups come from ``jax.distributed.initialize``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed() -> None:
    """Initialize the multi-host process group when launched under a
    multi-host runtime (no-op single-host)."""
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize()


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data × model) mesh over ``devices`` (defaults to all).

    ``data=None`` uses every remaining device after the model axis. The model
    axis is laid out innermost, so tensor-parallel groups are adjacent
    devices. (On cards joined all to all, any layout is equivalent.)
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n % model != 0:
        raise ValueError(f"model axis {model} does not divide device count {n}")
    data = data if data is not None else n // model
    if data * model != n:
        devices = devices[: data * model]
    grid = np.asarray(devices).reshape(data, model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def mesh_axis_sizes(mesh: Mesh) -> tuple[int, int]:
    return mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
