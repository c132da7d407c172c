"""Training checkpoint/resume via Orbax.

The reference has no checkpointing at all (SURVEY §5: the only 'checkpoint'
is the downloaded inference tarball). For the TPU training loop we use Orbax:
sharding-aware save/restore of (params, opt_state, step), retention of the
last N checkpoints, and export of final params into the inference weight-pack
format (``runtime/serialization.py``)."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import jax

from ..utils.logging import get_logger

log = get_logger("checkpoint")


class CheckpointManager:
    """Thin wrapper over orbax.checkpoint.CheckpointManager."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3, save_interval_steps: int = 1000):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.manager = ocp.CheckpointManager(
            self.directory,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep,
                save_interval_steps=save_interval_steps,
            ),
        )

    def save(self, step: int, params: Any, opt_state: Any, force: bool = False) -> bool:
        saved = self.manager.save(
            step,
            args=self._ocp.args.Composite(
                params=self._ocp.args.StandardSave(params),
                opt_state=self._ocp.args.StandardSave(opt_state),
            ),
            force=force,
        )
        if saved:
            log.info("Saved checkpoint at step %d → %s", step, self.directory)
        return bool(saved)

    def latest_step(self) -> Optional[int]:
        return self.manager.latest_step()

    def restore(self, step: Optional[int] = None, templates: Optional[dict] = None):
        """Restore (params, opt_state) at ``step`` (default: latest).

        ``templates``: optional {'params': tree, 'opt_state': tree} of
        abstract arrays/shardings guiding layout-aware restoration."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        if templates:
            args = self._ocp.args.Composite(
                params=self._ocp.args.StandardRestore(templates["params"]),
                opt_state=self._ocp.args.StandardRestore(templates["opt_state"]),
            )
            restored = self.manager.restore(step, args=args)
        else:
            restored = self.manager.restore(step)
        log.info("Restored checkpoint step %d", step)
        return restored["params"], restored["opt_state"], step

    def export_for_inference(self, params: Any, pack_dir: str | Path) -> None:
        """Write trained params into the inference weight pack."""
        from ..runtime.serialization import PARAMS_FILE, save_params

        host = jax.tree.map(lambda x: jax.device_get(x), params)
        save_params(Path(pack_dir) / PARAMS_FILE, host)
        log.info("Exported params to %s", pack_dir)

    def close(self) -> None:
        self.manager.close()
