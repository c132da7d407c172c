"""End-to-end training loop: data → sharded train steps → checkpoints.

Composes the pieces (``data.py``, ``train.py``, ``checkpoint.py``,
``parallel/``) into one callable so ``python -m vietvoice_tts_tpu.training``
can train the DiT from a manifest. Resumes from the latest checkpoint when
one exists, and exports inference weights into the pack on completion.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import jax
import numpy as np

from ..config import ModelConfig
from ..models.dit import DiTConfig
from ..parallel.mesh import make_mesh
from ..parallel.sharding import batch_sharding, shard_params
from ..runtime.session import ModelSessionManager
from ..utils.logging import get_logger
from .checkpoint import CheckpointManager
from .data import TextMelDataset, load_manifest, manifest_from_pack
from .train import TrainConfig, init_train_state, make_train_step

log = get_logger("train_loop")


@dataclass
class TrainRunConfig:
    steps: int = 10_000
    batch_size: int = 8
    checkpoint_dir: str = "checkpoints/dit"
    checkpoint_every: int = 500
    log_every: int = 50
    export_to_pack: bool = True


def train(
    model_config: Optional[ModelConfig] = None,
    train_config: Optional[TrainConfig] = None,
    run_config: Optional[TrainRunConfig] = None,
    manifest_path: Optional[str] = None,
    mesh=None,
) -> dict:
    """Train the flow-matching DiT; returns summary stats."""
    model_config = model_config or ModelConfig()
    train_config = train_config or TrainConfig()
    run = run_config or TrainRunConfig()

    # Weight pack gives us vocab + init params (+ toy manifest fallback).
    session = ModelSessionManager(model_config)
    session.load_models()
    records = (
        load_manifest(manifest_path)
        if manifest_path
        else manifest_from_pack(model_config.model_path)
    )
    dataset = TextMelDataset(
        records, model_config, session.vocab_path, batch_size=run.batch_size
    )

    dit_cfg = DiTConfig(
        dim=model_config.dit_dim,
        depth=model_config.dit_depth,
        heads=model_config.dit_heads,
        ff_mult=model_config.dit_ff_mult,
        n_mels=model_config.n_mels,
        text_dim=model_config.text_dim,
        text_conv_layers=model_config.text_conv_layers,
        vocab_size=session.vocab_size,
        compute_dtype=jax.numpy.dtype(model_config.compute_dtype),
    )

    if mesh is None and model_config.mesh_data_axis * model_config.mesh_model_axis > 1:
        mesh = make_mesh(model_config.mesh_data_axis, model_config.mesh_model_axis)

    params = session.params["dit"]
    if mesh is not None:
        from ..models.vocoder import VocoderConfig

        voc_cfg = VocoderConfig(n_mels=model_config.n_mels)
        params = shard_params(
            {"dit": params, "vocoder": session.params["vocoder"]},
            mesh, dit_cfg, voc_cfg,
        )["dit"]
    opt_state = init_train_state(params, train_config)

    ckpt = CheckpointManager(
        run.checkpoint_dir, save_interval_steps=run.checkpoint_every
    )
    start_step = 0
    if ckpt.latest_step() is not None:
        # Fresh (params, opt_state) act as structure templates so orbax
        # rebuilds the optax NamedTuple state instead of plain dicts.
        params, opt_state, start_step = ckpt.restore(
            templates={"params": params, "opt_state": opt_state}
        )
        log.info("Resumed from checkpoint step %d", start_step)

    # Donating (params, opt_state) lets XLA update the optimizer state in
    # place — without it peak HBM holds two full copies of both.
    step_fn = jax.jit(make_train_step(dit_cfg, train_config), donate_argnums=(0, 1))
    key = jax.random.PRNGKey(model_config.random_seed)
    losses: list[float] = []
    step = start_step
    data_iter = iter(dataset)
    while step < run.steps:
        try:
            mel, text_ids, lengths = next(data_iter)
        except StopIteration:
            data_iter = iter(dataset)
            continue
        if mesh is not None:
            mel, text_ids, lengths = (
                jax.device_put(a, batch_sharding(mesh, a.ndim))
                for a in (mel, text_ids, lengths)
            )
        key, sub = jax.random.split(key)
        params, opt_state, loss = step_fn(
            params, opt_state, sub, mel, text_ids, lengths
        )
        step += 1
        losses.append(float(loss))
        if step % run.log_every == 0:
            log.info("step %d: loss %.4f", step, np.mean(losses[-run.log_every:]))
        ckpt.save(step, params, opt_state)

    if ckpt.latest_step() != step:
        ckpt.save(step, params, opt_state, force=True)
    ckpt.manager.wait_until_finished()
    if run.export_to_pack:
        from ..runtime.serialization import PARAMS_FILE, load_params, save_params

        pack = Path(model_config.model_path)
        full = load_params(pack / PARAMS_FILE)
        full["dit"] = jax.tree.map(np.asarray, jax.device_get(params))
        save_params(pack / PARAMS_FILE, full)
        log.info("Exported trained DiT into %s", pack)
    ckpt.close()
    return {"final_step": step, "final_loss": losses[-1] if losses else None}
