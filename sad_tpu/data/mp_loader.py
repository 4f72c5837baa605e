"""Multi-process host data pipeline.

The threaded TrainingLoader (data/loader.py) is GIL-bound: minibatch building
is numpy-hot (resize, anchor labeling), while one accelerator consumes
images faster than one host core builds them. The reference
sidesteps the GIL because cv2 releases it (lib/roi_data/loader.py:66-115,
4 loader threads were enough for Caffe2); our equivalent is real processes.

Design: worker processes each hold a private copy of the roidb(s) and the
minibatch builder (shipped once at spawn). A dispatcher thread in the parent
samples batch index lists from the SAME epoch-shuffled, aspect-grouped
streams as the threaded loader (loader._Stream) and assigns the SAME
deterministic per-batch seeds; the collector restores DISPATCH order with
per-stream sequence numbers, so the surfaced batch stream is byte-identical
to a 1-thread TrainingLoader for ANY num_workers (reproducible training
independent of host parallelism — stronger than the reference's
completion-ordered threads). Built batches (pytrees of numpy arrays) return
through a multiprocessing queue — pickle-5 buffer frames make this a memcpy
through an OS pipe — into per-stream host queues; the consumer-facing
surface (get_next_batch with strict labeled/unlabeled parity alternation,
queue_depth, shutdown, context manager) matches TrainingLoader exactly, so
DevicePrefetcher and the train loop are oblivious.

Semi-supervised semantics preserved from the reference: the dispatcher
fills whichever stream is further behind (lib/roi_data/loader.py:109-115);
get_next_batch strictly alternates by batch parity (loader.py:140-146).

Worker errors are shipped back as formatted tracebacks and re-raised on the
consumer thread after already-built batches drain (matching the threaded
loader's error propagation). Uses the 'spawn' start method: the parent has
live JAX client threads that must not be forked, and the workers run with
JAX_PLATFORMS=cpu (worker_environment) so none opens the accelerator.
"""

from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import threading
import traceback
from typing import Dict, List, Optional

from sad_tpu.config import Config

from .loader import _Stream
from .minibatch import RetinaNetMinibatchBuilder

_SENTINEL = "__stop__"
_ERROR = "__error__"

# worker-global state, set once by _worker_init (spawned processes)
_W: dict = {}


def _worker_init(builder, roidbs):
    # (OMP_NUM_THREADS is inherited from the parent, set around spawn —
    # BLAS pools initialize at the child's numpy import, before this runs)
    _W["builder"] = builder
    _W["roidbs"] = roidbs


def _worker_loop(task_q, result_q, builder, roidbs):
    _worker_init(builder, roidbs)
    while True:
        task = task_q.get()
        if task == _SENTINEL:
            return
        stream, seq, indices, seed = task
        try:
            entries = [_W["roidbs"][stream][i] for i in indices]
            built = _W["builder"].build(entries, seed=seed)
            batch = built.as_pytree() if hasattr(built, "as_pytree") else built
            result_q.put((stream, seq, batch))
        except BaseException:  # noqa: BLE001 — ship to parent
            result_q.put((_ERROR, 0, traceback.format_exc()))
            return


@contextlib.contextmanager
def worker_environment():
    """The environment spawned loader workers inherit.

    - JAX_PLATFORMS=cpu: a worker must never open the accelerator. A JAX
      process reserves most of a GPU's memory when it first touches it, so a
      worker that did would starve the trainer.
    - OMP_NUM_THREADS=1 unless the operator set it: BLAS/OpenMP pools size
      themselves when the child imports numpy, during spawn bootstrap, so N
      workers would otherwise each open a cores-wide thread pool.

    The parent's environment is restored on exit."""
    saved = {k: os.environ.get(k) for k in ("JAX_PLATFORMS", "OMP_NUM_THREADS")}
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class MultiprocessTrainingLoader:
    """Process-pool minibatch building behind the TrainingLoader interface."""

    def __init__(
        self,
        cfg: Config,
        roidb: List[dict],
        teacher_cfg: Optional[Config] = None,
        unlabeled_roidb: Optional[List[dict]] = None,
        batch_images: int = None,
        num_workers: int = None,
        queue_capacity: int = 4,
        seed: int = 3,
        builder=None,
        skip_batches: int = 0,
    ):
        self.cfg = cfg
        self.builder = builder or RetinaNetMinibatchBuilder(cfg, teacher_cfg)
        self.batch_images = batch_images or (
            cfg.TRAIN.IMS_PER_BATCH * cfg.NUM_GPUS
        )
        self.num_workers = num_workers or max(1, (os.cpu_count() or 2) - 1)
        self._capacity = queue_capacity
        self._seed = seed
        self.labeled = _Stream(roidb, self.batch_images, seed)
        self.unlabeled = (
            _Stream(unlabeled_roidb, self.batch_images, seed + 1)
            if unlabeled_roidb
            else None
        )
        self._streams = {"labeled": self.labeled}
        if self.unlabeled:
            self._streams["unlabeled"] = self.unlabeled
        self._roidbs = {"labeled": roidb}
        if unlabeled_roidb:
            self._roidbs["unlabeled"] = unlabeled_roidb

        # UNBOUNDED consumer queues: the dispatcher's backlog accounting
        # (_lagging_stream, qsize + inflight < capacity + 1) is the real
        # memory bound, so a bounded put buys nothing — and it deadlocked
        # the single collector on chip (round 4, threaded-loader stack dump
        # of the same shape): blocked put()ing to the full labeled queue,
        # unable to move the unlabeled result the consumer was waiting on.
        self._queues: Dict[str, queue.Queue] = {
            name: queue.Queue() for name in self._streams
        }
        # order restoration: batches are surfaced in DRAW order, not
        # completion order, so the batch stream is byte-identical for any
        # num_workers (reproducible training independent of host parallelism;
        # the reference's threads were completion-ordered). The sequence
        # number is the stream's own draw counter (atomic with the draw).
        self._next_seq = {name: 0 for name in self._streams}
        self._pending: Dict[str, Dict[int, object]] = {
            name: {} for name in self._streams
        }
        self._inflight = {name: 0 for name in self._streams}
        self._inflight_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._batch_parity = 0
        if skip_batches:
            from .loader import fast_forward_streams

            fast_forward_streams(self.labeled, self.unlabeled, skip_batches)
            self._batch_parity = skip_batches
            self._next_seq = {
                name: self._streams[name].count for name in self._streams
            }

        self._ctx = mp.get_context("spawn")
        self._task_q = self._ctx.Queue()
        self._result_q = self._ctx.Queue()
        self._procs: List[mp.Process] = []
        self._dispatcher = threading.Thread(
            target=self._dispatch, daemon=True, name="mp-loader-dispatch"
        )
        self._collector = threading.Thread(
            target=self._collect, daemon=True, name="mp-loader-collect"
        )

    # ---------------------------------------------------------------- start

    def start(self, prefill: bool = False):
        with worker_environment():
            for i in range(self.num_workers):
                p = self._ctx.Process(
                    target=_worker_loop,
                    args=(
                        self._task_q, self._result_q, self.builder,
                        self._roidbs,
                    ),
                    daemon=True,
                    name=f"mp-loader-{i}",
                )
                p.start()
                self._procs.append(p)
        self._dispatcher.start()
        self._collector.start()
        if prefill:
            import time

            # queues are unbounded (full() is never true): prefill to the
            # dispatcher's capacity bound instead
            target = self._capacity * len(self._queues)
            while (
                self.queue_depth() < target
                and self._error is None
                and not self._stop.is_set()
            ):
                time.sleep(0.05)
        return self

    # ------------------------------------------------------------- dispatch

    def _lagging_stream(self) -> Optional[str]:
        """Next stream to fill: whichever is further behind its capacity,
        counting batches already built and batches in flight."""
        with self._inflight_lock:
            backlog = {
                name: self._queues[name].qsize() + self._inflight[name]
                for name in self._streams
            }
            candidates = [
                n for n, b in backlog.items() if b < self._capacity + 1
            ]
            if not candidates:
                return None
            name = min(candidates, key=backlog.get)
            self._inflight[name] += 1
            return name

    def _dispatch(self):
        import time

        while not self._stop.is_set():
            name = self._lagging_stream()
            if name is None:
                time.sleep(0.01)
                continue
            stream = self._streams[name]
            # ship indices, not entries — workers hold their own roidb copy;
            # identical PER-STREAM seed schedule to the threaded loader
            # (loader._Stream.next_batch_indices_seeded)
            idxs, bseed, seq = stream.next_batch_indices_seeded()
            self._task_q.put((name, seq, idxs, bseed))

    def _check_dead_workers(self) -> bool:
        """Liveness: a worker that died WITHOUT shipping a traceback
        (OOM-kill, SIGKILL, segfault in native code) would otherwise hang the
        consumer — its claimed _inflight slot (or its hole in the restored
        sequence) is never released, so even ONE such death eventually
        starves the pipeline. Any abnormal exit is fatal (the threaded
        loader always raises); exitcode 0 means a clean return whose _ERROR
        message, if any, is already in the queue. Called periodically from
        the collector REGARDLESS of result traffic: with N-1 surviving
        workers the result pipe may never starve, so starvation alone is
        not a usable death signal."""
        dead = [
            p for p in self._procs
            if not p.is_alive() and p.exitcode not in (None, 0)
        ]
        if dead:
            codes = [p.exitcode for p in dead]
            self._error = RuntimeError(
                f"{len(dead)} minibatch worker(s) died (exit codes "
                f"{codes}) without reporting an error — likely OOM "
                "or a native crash"
            )
            self._stop.set()
            return True
        return False

    def _collect(self):
        import time

        last_scan = time.monotonic()
        while not self._stop.is_set():
            now = time.monotonic()
            if now - last_scan > 0.5:
                last_scan = now
                if self._check_dead_workers():
                    return
            try:
                kind, seq, payload = self._result_q.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return  # shutdown terminates workers (exitcode -15)
                continue
            except (EOFError, OSError):
                return
            if kind == _ERROR:
                self._error = RuntimeError(
                    f"minibatch worker failed:\n{payload}"
                )
                self._stop.set()
                return
            # restore dispatch order: hold out-of-order completions until
            # every earlier sequence number for this stream has surfaced
            self._pending[kind][seq] = payload
            while self._next_seq[kind] in self._pending[kind]:
                item = self._pending[kind].pop(self._next_seq[kind])
                # unbounded put (see __init__): the collector must NEVER
                # block — a blocked collector can't surface the OTHER
                # stream's results and deadlocks the parity-alternating
                # consumer
                self._queues[kind].put(item)
                self._next_seq[kind] += 1
                with self._inflight_lock:
                    self._inflight[kind] -= 1

    # ------------------------------------------------------------- consumer

    def get_next_batch(self) -> Dict:
        """Strictly alternate labeled/unlabeled by parity (ref
        loader.py:140-146); drain built batches before surfacing an error."""
        name = "labeled"
        if self.unlabeled:
            name = "labeled" if self._batch_parity % 2 == 0 else "unlabeled"
        self._batch_parity += 1
        while True:
            try:
                return self._queues[name].get_nowait()
            except queue.Empty:
                pass
            if self._error is not None:
                raise RuntimeError("minibatch worker failed") from self._error
            try:
                return self._queues[name].get(timeout=1.0)
            except queue.Empty:
                continue

    def queue_depth(self) -> int:
        return sum(q.qsize() for q in self._queues.values())

    def shutdown(self):
        self._stop.set()
        for _ in self._procs:
            try:
                self._task_q.put_nowait(_SENTINEL)
            except queue.Full:
                pass
        for q in self._queues.values():
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        # drain the result pipe so workers blocked on put can exit
        try:
            while True:
                self._result_q.get_nowait()
        except (queue.Empty, EOFError, OSError):
            pass
        for p in self._procs:
            p.join(timeout=2.0)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for t in (self._dispatcher, self._collector):
            if t.is_alive():
                t.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()
