"""Continuous micro-batching for concurrent synthesis requests.

The reference serializes all requests through one engine guarded by a worker
thread (``/root/reference/vietvoicetts/api/tts_engine.py:64-87`` documents the
single-worker restriction). Here concurrent requests share the accelerator:
chunk jobs from any number of client threads land in a queue; a dispatcher
thread greedily groups jobs with the same frame bucket into one padded device
batch (up to ``max_batch``, waiting at most ``max_wait_ms`` for co-riders)
and runs them through the EngineCore's fused program. Per-row seeds keep each
request's audio independent of its batchmates (``models/sampler.py``), so
batching is invisible to callers.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import pad_batch_size
from ..runtime.engine_core import EngineCore
from ..utils.logging import get_logger

log = get_logger("batcher")


@dataclass
class ChunkJob:
    """One frame-bucket-padded chunk ready for the device."""

    bucket: int
    wave: np.ndarray  # [bucket * hop] f32
    ref_len: int
    total_len: int
    text_ids: np.ndarray  # [bucket] int32, -1 padded
    seed: int
    future: Future = field(default_factory=Future)
    attempts: int = 0  # failed dispatch/fetch attempts so far
    ts: float = field(default_factory=time.monotonic)  # arrival (aging guard)
    # Leading frames the device program dropped before the fetch (EngineCore
    # ``trim_ref_frames``): the resolved row STARTS at this frame. Set by the
    # dispatcher per batch; callers slice with ``ref_len - trimmed``.
    trimmed: int = 0


# Retry backoff: attempt k waits RETRY_BASE_S * 2**(k-1), capped. Keeps a
# persistently failing dispatch from hot-looping against a sick device while
# still recovering quickly from one-off transfer hiccups.
RETRY_BASE_S = 0.05
RETRY_MAX_S = 1.0


@dataclass
class BatcherStats:
    batches: int = 0
    jobs: int = 0
    padded_rows: int = 0
    retries: int = 0  # jobs re-queued after a transient batch failure
    failures: int = 0  # jobs that exhausted retries

    @property
    def mean_batch_size(self) -> float:
        return self.jobs / self.batches if self.batches else 0.0


class MicroBatcher:
    """Queue → bucket-grouped padded batches → fused chunk program.

    Futures resolve to device rows whose leading ``job.trimmed`` reference
    frames were dropped ON DEVICE (EngineCore ``trim_ref_frames``) before
    the fetch — callers discard the reference prefix anyway, so those bytes
    need not reach the host. ``pick_trim``
    only ever selects classes ``warmup()`` compiled, so dispatch never pays
    a cold XLA compile; unwarmed shapes run untrimmed (``trimmed == 0``,
    the old full-row contract)."""

    def __init__(
        self,
        engine_core: EngineCore,
        max_batch: Optional[int] = None,
        max_wait_ms: float = 5.0,
        retries: int = 1,
        max_starve_ms: float = 500.0,
        pipeline_depth: int = 1,
    ):
        self.core = engine_core
        self.max_batch = max_batch or engine_core.config.max_batch_size
        self.pipeline_depth = pipeline_depth
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_starve_s = max_starve_ms / 1000.0
        self.retries = retries
        self._queue: "queue.Queue[Optional[ChunkJob]]" = queue.Queue()
        # Jobs pulled off the queue but not yet dispatched (bucket-aware
        # grouping keeps minority buckets here instead of re-queueing them
        # at the tail — see _collect).
        self._pending: deque[ChunkJob] = deque()
        self._stats = BatcherStats()
        self._running = True
        # Serializes ensure_running/shutdown so two concurrent repair calls
        # never start duplicate thread pairs racing one queue. submit() stays
        # lock-free: _running only ever flips False at shutdown, never during
        # repair, so clients keep enqueueing through a repair window.
        self._lifecycle_lock = threading.Lock()
        # Thread generation. Worker loops capture the generation they were
        # started with and exit as soon as it moves on; a wake-up sentinel
        # (None) read by a CURRENT-generation worker is stale by definition
        # (it was posted to retire a previous generation) and is discarded,
        # so repair never needs to drain queues or guess which consumer died.
        self._gen = 0
        # Failure bookkeeping (surfaced at /api/v1/health): last batch error
        # and its wall-clock time. A failed batch does NOT fail its jobs
        # outright — each rides a fresh dispatch up to ``retries`` times
        # (a transient device or transfer error does not fail its jobs).
        self.last_error: Optional[str] = None
        self.last_error_ts: Optional[float] = None
        # Two-stage pipeline: the dispatcher thread enqueues async device
        # work; the fetcher thread blocks on the D2H transfers.
        # maxsize bounds in-flight batches BEYOND the one being fetched —
        # dispatch of batch k+1+depth waits until batch k's result has been
        # fetched (backpressure). With the collect-while-blocked scheduler
        # the device stays saturated at depth 1 (next batch dispatched while
        # the current computes; compute overlaps the previous fetch's D2H).
        # Depth 1 queues the least work ahead of a newly arriving request,
        # so it is the default; depth 2 is not measured on the GPU.
        self._inflight: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=max(1, pipeline_depth)
        )
        self._start_threads()

    def _start_threads(self) -> None:
        self._gen += 1
        gen = self._gen
        self._thread = threading.Thread(
            target=self._loop, args=(gen,), daemon=True, name="vv-batcher"
        )
        self._fetcher = threading.Thread(
            target=self._fetch_loop, args=(gen,), daemon=True, name="vv-batcher-fetch"
        )
        self._thread.start()
        self._fetcher.start()

    # -- Client side ---------------------------------------------------------

    def submit(self, job: ChunkJob) -> Future:
        if not self._running:
            raise RuntimeError("MicroBatcher is shut down")
        self._queue.put(job)
        if not self._running:
            # Raced a concurrent shutdown past its queue drain: the job just
            # landed in a queue nobody will ever read — fail it (and any
            # co-stragglers) rather than hang the caller on future.result().
            self._fail_queued()
            raise RuntimeError("MicroBatcher is shut down")
        return job.future

    def _fail_queued(self) -> None:
        """Fail every job still in the queue or pending deque (shutdown)."""
        leftovers: list[Optional[ChunkJob]] = list(self._pending)
        self._pending.clear()
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for job in leftovers:
            if job is not None and not job.future.done():
                job.future.set_exception(RuntimeError("MicroBatcher is shut down"))

    @property
    def stats(self) -> BatcherStats:
        return self._stats

    @property
    def healthy(self) -> bool:
        """True when both worker threads are alive (and not shut down).

        The loops catch ``Exception``; a thread can still die on a
        non-Exception ``BaseException`` (interpreter teardown, injected
        interrupts). Liveness is therefore observable — load balancers read
        it through ``GET /api/v1/health`` — and repairable via
        ``ensure_running``."""
        return self._running and self._thread.is_alive() and self._fetcher.is_alive()

    def ensure_running(self) -> bool:
        """Restart any dead worker thread; returns post-repair health.

        Queued and in-flight work survives the restart: jobs live in
        ``_queue``/``_inflight``, not in thread state. ``_running`` is never
        flipped during repair, so concurrent ``submit`` calls keep being
        accepted. Serialized with ``shutdown`` via the lifecycle lock. No-op
        after ``shutdown`` (returns False)."""
        with self._lifecycle_lock:
            if not self._running:
                return False
            if self._thread.is_alive() and self._fetcher.is_alive():
                return True
            log.warning(
                "Batcher thread death detected (dispatcher=%s fetcher=%s); restarting",
                self._thread.is_alive(),
                self._fetcher.is_alive(),
            )
            # Retire any survivor cleanly before restarting the pair, so two
            # dispatchers never race one queue. Bumping the generation makes
            # the survivor's loop exit at its next wake-up; the sentinel only
            # goes into a queue whose consumer is actually alive (a sentinel
            # for a dead consumer would sit in the queue and kill its
            # freshly-started replacement — the old partial-death bug).
            self._gen += 1
            if self._thread.is_alive():
                self._queue.put(None)
                self._thread.join(timeout=5.0)
            if self._fetcher.is_alive():
                try:
                    # put can block when _inflight is full; the live fetcher
                    # drains it within one fetch, but bound the wait anyway.
                    self._inflight.put(None, timeout=5.0)
                except queue.Full:  # pragma: no cover — fetch wedged
                    pass
                self._fetcher.join(timeout=5.0)
            self._start_threads()
            return self.healthy

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._lifecycle_lock:
            self._running = False
        self._queue.put(None)
        self._thread.join(timeout=timeout)
        try:
            self._inflight.put(None, timeout=timeout)
        except queue.Full:  # pragma: no cover — fetch wedged at shutdown
            pass
        self._fetcher.join(timeout=timeout)
        # Fail (don't hang) futures still queued OR pending at shutdown.
        self._fail_queued()

    # -- Dispatcher ----------------------------------------------------------

    def _largest_group(self) -> int:
        counts: dict[int, int] = {}
        for j in self._pending:
            counts[j.bucket] = counts.get(j.bucket, 0) + 1
        return max(counts.values(), default=0)

    def _collect(self) -> list[ChunkJob]:
        """Gather one device batch, bucket-aware across the whole queue head.

        Two scheduling properties close a queueing gap (small batches
        while requests waited):

        1. **The collection window spans device-busy time.** The old loop
           collected for max_wait_ms, then blocked in ``_inflight.put`` —
           every job arriving during the in-flight batch missed
           the bus it was about to catch and seeded a small straggler batch
           instead. Now, while the in-flight pipeline is full the collector
           keeps draining the queue (the dispatch couldn't proceed anyway),
           so the batch that goes out when a slot frees carries everyone
           who queued during the wait. max_wait_ms still bounds the ADDED
           latency when the device is idle.

        2. **Minority buckets wait here, not at the queue tail.** The old
           collector spilled different-bucket jobs back into the queue
           (scrambling arrival order and re-scanning them every round) and
           dispatched the FIRST job's bucket even when a full co-rider set
           of another bucket was ready. Now all drained jobs stay in
           ``_pending``; the dispatched group is the largest bucket cohort,
           unless the oldest waiting job has aged past ``max_starve_ms`` —
           then its bucket goes first (bounded worst-case wait for odd
           buckets under a steady majority stream)."""
        if not self._pending:
            first = self._queue.get()
            if first is None:
                return []
            self._pending.append(first)
        deadline = time.monotonic() + self.max_wait_s
        while True:
            now = time.monotonic()
            blocked = self._inflight.full()
            full = self._largest_group() >= self.max_batch
            if not blocked and (now >= deadline or full):
                break
            # While the pipeline is blocked, poll in short slices so the
            # moment a slot frees we dispatch with everything gathered.
            timeout = 0.005 if blocked else (deadline - now)
            try:
                job = self._queue.get(timeout=timeout)
            except queue.Empty:
                if blocked:
                    continue
                break
            if job is None:
                self._queue.put(None)  # re-post sentinel for shutdown
                break
            self._pending.append(job)

        # Pick the dispatch group: oldest job's bucket if it is starving,
        # else the largest cohort (ties go to the cohort of the oldest
        # member, preserving arrival order).
        oldest = self._pending[0]
        groups: dict[int, list[ChunkJob]] = {}
        for j in self._pending:
            groups.setdefault(j.bucket, []).append(j)
        if time.monotonic() - oldest.ts > self.max_starve_s:
            bucket = oldest.bucket
        else:
            best = max(len(g) for g in groups.values())
            bucket = next(
                j.bucket for j in self._pending if len(groups[j.bucket]) == best
            )
        batch = groups[bucket][: self.max_batch]
        taken = set(map(id, batch))
        self._pending = deque(j for j in self._pending if id(j) not in taken)
        return batch

    def _run_batch(self, jobs: list[ChunkJob]) -> None:
        bucket = jobs[0].bucket
        # Pad the row count up to the batch grid (powers of two capped at
        # max_batch) so the jit cache holds at most log2(max_batch)+2
        # programs per bucket instead of one per distinct batch size
        # (compiles cost minutes on this host), and the dispatched shape
        # never exceeds the configured cap.
        b = len(jobs)
        padded = pad_batch_size(b, self.max_batch)
        # Padding rows take the real rows' min ref_len (their output is
        # discarded) so pick_trim isn't forced to 0 by a padding row.
        fill_ref = min(j.ref_len for j in jobs)
        wave = np.zeros((padded, jobs[0].wave.shape[0]), np.float32)
        ref_len = np.full((padded,), fill_ref, np.int32)
        total_len = np.full((padded,), max(1, min(fill_ref, bucket)), np.int32)
        text_ids = np.full((padded, bucket), -1, np.int32)
        seeds = np.zeros((padded,), np.uint32)
        for row, j in enumerate(jobs):
            wave[row] = j.wave
            ref_len[row] = j.ref_len
            total_len[row] = j.total_len
            text_ids[row] = j.text_ids
            seeds[row] = j.seed
        trim = self.core.pick_trim(padded, bucket, ref_len)
        for j in jobs:
            j.trimmed = trim
        fetch = self.core.synthesize_batch_async(
            wave, ref_len, text_ids, total_len, seed=seeds, trim_ref_frames=trim
        )
        self._inflight.put((fetch, jobs))
        log.debug(
            "dispatched batch: bucket=%d size=%d padded=%d trim=%d",
            bucket, b, padded, trim,
        )

    def _requeue_later(self, job: ChunkJob, delay: float) -> None:
        """Re-queue a failed job after a backoff delay (daemon timer thread).

        If the batcher shut down while the timer was pending, fail the future
        instead of parking the job in a queue nobody will drain."""

        def fire() -> None:
            if self._running:
                self._queue.put(job)
            elif not job.future.done():
                job.future.set_exception(RuntimeError("MicroBatcher is shut down"))

        t = threading.Timer(delay, fire)
        t.daemon = True
        t.start()

    def _fail_or_retry(self, jobs: list[ChunkJob], exc: Exception) -> None:
        """Batch failed: re-queue each job for a fresh dispatch while it has
        attempts left (with exponential backoff so a sick device isn't
        hot-looped); fail its future once retries are exhausted. A batch
        failure is recorded either way (health observability)."""
        self.last_error = f"{type(exc).__name__}: {exc}"
        self.last_error_ts = time.time()
        for job in jobs:
            if job.future.done():
                continue
            if self._running and job.attempts < self.retries:
                job.attempts += 1
                self._stats.retries += 1
                delay = min(RETRY_BASE_S * (2 ** (job.attempts - 1)), RETRY_MAX_S)
                log.warning(
                    "Retrying job (attempt %d/%d, backoff %.0f ms) after batch error: %s",
                    job.attempts,
                    self.retries,
                    delay * 1000,
                    exc,
                )
                self._requeue_later(job, delay)
            else:
                self._stats.failures += 1
                job.future.set_exception(exc)

    def _fetch_loop(self, gen: int) -> None:
        while True:
            item = self._inflight.get()
            if item is None:
                if not self._running or gen != self._gen:
                    return
                continue  # stale sentinel from a previous generation's repair
            fetch, jobs = item
            try:
                out = fetch()
            except Exception as e:  # noqa: BLE001 — retry, then propagate
                self._fail_or_retry(jobs, e)
                continue
            self._stats.batches += 1
            self._stats.jobs += len(jobs)
            self._stats.padded_rows += out.shape[0] - len(jobs)
            # Recovery observability: a successful batch clears the sticky
            # error so /health stops reporting a stale incident.
            self.last_error = None
            self.last_error_ts = None
            for row, job in enumerate(jobs):
                job.future.set_result(out[row])

    def _loop(self, gen: int) -> None:
        while self._running and gen == self._gen:
            try:
                jobs = self._collect()
                if not jobs:
                    continue  # woken by a sentinel; loop condition re-checked
                try:
                    self._run_batch(jobs)
                except Exception as e:  # noqa: BLE001 — retry, then propagate
                    self._fail_or_retry(jobs, e)
            except Exception as e:  # pragma: no cover — keep dispatcher alive
                log.error("Batcher loop error: %s", e)
