"""NamedSharding specs for parameters and activations.

Tensor-parallel layout (Megatron-style column→row pairing, so each DiT block
needs exactly one ``psum`` — inserted automatically by XLA's SPMD partitioner
when the out-projection's input dim is sharded):

- ``qkv.w  [dim, 3·dim]``   → shard output dim on ``model`` (heads split)
- ``attn_out.w [dim, dim]`` → shard input dim on ``model``
- ``ff1.w  [dim, 4·dim]``   → shard output dim on ``model``
- ``ff2.w  [4·dim, dim]``   → shard input dim on ``model``
- vocoder ``pw1``/``pw2``   → same pairing over the intermediate dim
- everything else replicated; activations shard batch on ``data``.

No hand-written collectives: we annotate, XLA inserts `all-reduce`/
`all-gather` (scaling-book recipe).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, MODEL_AXIS


def _dit_block_spec() -> dict:
    # Blocks are stacked on a leading depth axis (lax.scan over layers), so
    # every spec carries a leading None for the depth dim.
    return {
        "ada": {"w": P(), "b": P()},
        "qkv": {"w": P(None, None, MODEL_AXIS), "b": P(None, MODEL_AXIS)},
        "attn_out": {"w": P(None, MODEL_AXIS, None), "b": P()},
        "ff1": {"w": P(None, None, MODEL_AXIS), "b": P(None, MODEL_AXIS)},
        "ff2": {"w": P(None, MODEL_AXIS, None), "b": P()},
    }


def _text_block_spec() -> dict:
    return {
        "dwconv": {"w": P(), "b": P()},
        "pw1": {"w": P(None, MODEL_AXIS), "b": P(MODEL_AXIS)},
        "pw2": {"w": P(MODEL_AXIS, None), "b": P()},
    }


def _vocoder_block_spec() -> dict:
    # Stacked on a leading depth axis, like the DiT blocks.
    return {
        "dwconv": {"w": P(), "b": P()},
        "pw1": {"w": P(None, None, MODEL_AXIS), "b": P(None, MODEL_AXIS)},
        "pw2": {"w": P(None, MODEL_AXIS, None), "b": P()},
        "gamma": P(),
        "norm_scale": P(),
        "norm_bias": P(),
    }


def param_pspecs(dit_cfg, voc_cfg) -> dict:
    """PartitionSpec pytree matching the params pytree structure."""
    return {
        "dit": {
            "text_embed": {
                "table": P(),
                "blocks": [_text_block_spec() for _ in range(dit_cfg.text_conv_layers)],
            },
            "time_embed": {
                "mlp1": {"w": P(), "b": P()},
                "mlp2": {"w": P(), "b": P()},
            },
            "input_proj": {"w": P(), "b": P()},
            "conv_pos": [{"w": P(), "b": P()} for _ in range(2)],
            "blocks": _dit_block_spec(),
            "final_ada": {"w": P(), "b": P()},
            "final_proj": {"w": P(), "b": P()},
        },
        "vocoder": {
            "embed": {"w": P(), "b": P()},
            "norm_in_scale": P(),
            "norm_in_bias": P(),
            "blocks": _vocoder_block_spec(),
            "norm_out_scale": P(),
            "norm_out_bias": P(),
            # 2·n_freqs (=1026) is not divisible by common TP sizes; the head
            # is a single small matmul — replicate it.
            "head": {"w": P(), "b": P()},
        },
    }


def param_shardings(mesh: Mesh, dit_cfg, voc_cfg):
    return jax.tree.map(
        lambda spec: NamedSharding(mesh, spec),
        param_pspecs(dit_cfg, voc_cfg),
        is_leaf=lambda x: isinstance(x, P),
    )


def shard_params(params, mesh: Mesh, dit_cfg, voc_cfg):
    """Place the parameter pytree on the mesh with TP shardings."""
    shardings = param_shardings(mesh, dit_cfg, voc_cfg)
    return jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x, jnp.float32), s), params, shardings
    )


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading batch dim on ``data``, replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def shard_batch(mesh: Mesh, *arrays: Any):
    """device_put each array with its batch-sharded layout."""
    return tuple(
        jax.device_put(a, batch_sharding(mesh, a.ndim)) for a in arrays
    )
