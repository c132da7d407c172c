"""Subprocess body for the REAL two-process multihost tests.

Launched twice by ``tests/test_multihost_2proc.py`` (process_id 0 and 1)
with a genuine ``jax.distributed`` runtime on the CPU backend — the actual
``multihost_utils.broadcast_one_to_all`` / Gloo codepath, no injected
fakes (round-3 verdict #3: the last untested seam before several hosts).

Modes (argv[4]):
- ``clean``: host 0 submits jobs, resolves them, then calls ``loop.stop()``
  — the coordinator broadcasts the cluster-stop sentinel, so the worker's
  loop must exit cleanly at the same protocol step. Both hosts record a
  SHA-1 of every real batch result; both must match bit-exactly.
- ``crash``: host 0 exits abruptly (``os._exit``) without stopping the
  cluster. The worker must TERMINATE (fail-stop — either its loop catches
  the broadcast failure, or Gloo aborts the process) rather than hang; the
  parent asserts termination within the deadline.
"""

import hashlib
import json
import os
import sys
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]
outdir = Path(sys.argv[3])
mode = sys.argv[4] if len(sys.argv) > 4 else "clean"

jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from conftest import tiny_config  # noqa: E402

from vietvoice_tts_tpu.runtime.engine_core import EngineCore  # noqa: E402
from vietvoice_tts_tpu.runtime.session import ModelSessionManager  # noqa: E402
from vietvoice_tts_tpu.serving.batcher import ChunkJob  # noqa: E402
from vietvoice_tts_tpu.serving.multihost import MultiHostServingLoop  # noqa: E402

BUCKET = 64
N_JOBS = 3

cfg = tiny_config(
    model_cache_dir=str(outdir / f"pack{pid}"),
    frame_buckets=(BUCKET,),
    voice_cond_cache=False,
)
mgr = ModelSessionManager(cfg)
mgr.load_models()
core = EngineCore(cfg, mgr.params, mgr.vocab_size)

# Record a hash of every real batch's output on BOTH hosts (heartbeat
# batches are all-zero ref_len and are skipped).
record: list = []
orig_async = core.synthesize_batch_async


def wrapped_async(wave, ref_len, text_ids, total_len, seed=0, trim_ref_frames=0):
    fetch = orig_async(
        wave, ref_len, text_ids, total_len, seed=seed,
        trim_ref_frames=trim_ref_frames,
    )
    is_real = bool((np.asarray(ref_len) > 0).any())

    def fetch_and_record():
        out = fetch()
        if is_real:
            record.append(hashlib.sha1(out.tobytes()).hexdigest())
        return out

    return fetch_and_record


core.synthesize_batch_async = wrapped_async

loop = MultiHostServingLoop(core, max_wait_ms=50.0)
loop.start()

hop = cfg.hop_length
deadline = time.monotonic() + 120.0
result = {"pid": pid, "mode": mode, "hashes": None, "ok": False}


def write(res):
    tmp = outdir / f"host{pid}.json.tmp"
    tmp.write_text(json.dumps(res))
    tmp.rename(outdir / f"host{pid}.json")


if pid == 0:
    rng = np.random.default_rng(7)
    futures = []
    for i in range(N_JOBS):
        wave = np.zeros((BUCKET * hop,), np.float32)
        wave[: 20 * hop] = rng.standard_normal(20 * hop).astype(np.float32) * 0.1
        ids = np.full((BUCKET,), -1, np.int32)
        ids[:30] = (np.arange(30) % 50) + 1
        futures.append(
            loop.submit(
                ChunkJob(
                    bucket=BUCKET, wave=wave, ref_len=20, total_len=50,
                    text_ids=ids, seed=i,
                )
            )
        )
    waves = [f.result(timeout=120.0) for f in futures]
    while time.monotonic() < deadline and len(record) < 1:
        time.sleep(0.05)
    result["hashes"] = list(record)
    result["job_hash"] = hashlib.sha1(
        b"".join(np.ascontiguousarray(w).tobytes() for w in waves)
    ).hexdigest()
    result["ok"] = True
    write(result)
    if mode == "clean":
        # Broadcasts the cluster-stop sentinel; the worker must exit too.
        loop.stop(timeout=30.0)
        sys.exit(0)
    else:
        # Give the worker time to fetch + record its copy of the real
        # batch, then die abruptly (no stop, no distributed shutdown):
        # the worker must fail-stop, not hang.
        time.sleep(3.0)
        os._exit(1)
else:
    # Worker: wait for the real batch to pass through, snapshot results
    # IMMEDIATELY (in crash mode the process may be aborted by Gloo when
    # the coordinator dies), then wait for the loop to stop.
    while time.monotonic() < deadline and len(record) < 1:
        time.sleep(0.05)
    saw_batch = len(record) >= 1
    result["hashes"] = list(record)
    result["saw_batch"] = saw_batch
    result["ok"] = saw_batch
    write(result)
    while time.monotonic() < deadline and loop._running:
        time.sleep(0.2)
    stopped = not loop._running
    loop._thread.join(timeout=10.0)
    # Re-snapshot AFTER the loop fully exited: the loop's final
    # _resolve(pending) records the last in-flight batch.
    result["hashes"] = list(record)
    result["stopped"] = stopped
    result["ok"] = saw_batch and stopped
    write(result)
    sys.exit(0 if result["ok"] else 1)
