"""Threaded host->device training data pipeline.

Capability-equivalent to detectron/lib/roi_data/loader.py (RoIDataLoader +
enqueue threads + Caffe2 BlobsQueue), redesigned:

- loader threads build whole static-shape batches (RetinaNetMinibatchBuilder)
  into a bounded host queue; the consumer transfers with jax.device_put and
  JAX's async dispatch overlaps transfer with the running step (replacing
  BlobsQueue/SafeEnqueueBlobs, loader.py:250-273 + queue/blobs_queue.cc),
- epoch shuffling with aspect grouping: landscape/portrait pools shuffled
  independently and batches drawn from one pool so every batch shares one
  canvas (ref: deque-rotation aspect grouping, loader.py:173-245),
- semi-supervised alternation: when an unlabeled roidb is present, batches
  strictly alternate labeled/unlabeled by batch parity (loader.py:140-146),
  and loader threads fill whichever stream is behind (loader.py:109-115),
- coordinator-style shutdown that drains threads on error or exit
  (lib/utils/coordinator.py:32-66).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from sad_tpu.config import Config

from .minibatch import RetinaNetMinibatchBuilder


class _Stream:
    """Epoch-shuffled index stream with aspect grouping."""

    def __init__(self, roidb: List[dict], batch_images: int, seed: int):
        if not roidb:
            raise ValueError(
                "empty roidb — check TRAIN.DATASETS and the dataset catalog"
            )
        self.roidb = roidb
        self.batch_images = batch_images
        # Per-stream batch-seed schedule: the k-th batch drawn from THIS
        # stream always gets seed (seed*1_000_003 + k), paired atomically
        # with the index draw. A global build counter (the previous design)
        # made two-stream runs irreproducible: the labeled/unlabeled
        # interleaving — and therefore the seed each batch got — depended on
        # queue timing. Per-stream counters make stream contents a pure
        # function of (roidb, seed, k), which is also what lets a resumed
        # run fast-forward to the exact batch sequence (skip()).
        self._seed = seed
        self.count = 0
        self.rng = np.random.RandomState(seed)
        self.landscape = [
            i for i, e in enumerate(roidb) if e["width"] >= e["height"]
        ]
        self.portrait = [
            i for i, e in enumerate(roidb) if e["width"] < e["height"]
        ]
        self._cursors = {}
        self._shuffled = {}
        self._lock = threading.Lock()
        for key in ("l", "p"):
            self._reshuffle(key)

    def _pool(self, key):
        return self.landscape if key == "l" else self.portrait

    def _reshuffle(self, key):
        pool = list(self._pool(key))
        self.rng.shuffle(pool)
        self._shuffled[key] = pool
        self._cursors[key] = 0

    def next_batch_indices(self) -> List[int]:
        return self.next_batch_indices_seeded()[0]

    def next_batch_indices_seeded(self) -> tuple:
        """(indices, batch_seed, seq) for the stream's next batch; the
        triple is drawn atomically so concurrent callers cannot mismatch
        draw, seed, and sequence position."""
        with self._lock:
            # prefer whichever orientation pool has more remaining
            keys = [k for k in ("l", "p") if len(self._pool(k)) >= 1]
            key = max(
                keys,
                key=lambda k: len(self._shuffled[k]) - self._cursors[k],
            )
            idxs = []
            while len(idxs) < self.batch_images:
                if self._cursors[key] >= len(self._shuffled[key]):
                    self._reshuffle(key)
                idxs.append(self._shuffled[key][self._cursors[key]])
                self._cursors[key] += 1
            seq = self.count
            bseed = (self._seed * 1_000_003 + seq) % (2 ** 31)
            self.count += 1
        return idxs, bseed, seq

    def next_batch(self) -> List[dict]:
        return [self.roidb[i] for i in self.next_batch_indices()]

    def skip(self, n: int) -> None:
        """Fast-forward n batch draws (resume support: a run resumed at iter
        k replays the identical batch sequence from k onward)."""
        for _ in range(n):
            self.next_batch_indices_seeded()


def fast_forward_streams(labeled, unlabeled, skip_batches: int) -> None:
    """Advance stream draws to position `skip_batches` of the CONSUMED
    sequence (resume support). With an unlabeled stream the consumer
    alternates by parity — labeled on even batches — so the labeled stream
    has supplied ceil(k/2) batches and the unlabeled floor(k/2)."""
    if unlabeled is not None:
        labeled.skip((skip_batches + 1) // 2)
        unlabeled.skip(skip_batches // 2)
    else:
        labeled.skip(skip_batches)


class TrainingLoader:
    """Prefetching loader; get_next_batch() yields host batch pytrees."""

    def __init__(
        self,
        cfg: Config,
        roidb: List[dict],
        teacher_cfg: Optional[Config] = None,
        unlabeled_roidb: Optional[List[dict]] = None,
        batch_images: int = None,
        num_threads: int = 2,
        queue_capacity: int = 4,
        seed: int = 3,
        builder=None,
        skip_batches: int = 0,
    ):
        self.cfg = cfg
        # builder: any object with canvas_for(entry) + build(entries) —
        # RetinaNetMinibatchBuilder by default; RCNNMinibatchBuilder for the
        # Faster/Mask R-CNN path (data/rpn_minibatch.py)
        self.builder = builder or RetinaNetMinibatchBuilder(cfg, teacher_cfg)
        self.batch_images = batch_images or (cfg.TRAIN.IMS_PER_BATCH * cfg.NUM_GPUS)
        self.labeled = _Stream(roidb, self.batch_images, seed)
        self.unlabeled = (
            _Stream(unlabeled_roidb, self.batch_images, seed + 1)
            if unlabeled_roidb
            else None
        )
        self._seed = seed
        # UNBOUNDED queues + a claim-side capacity bound (below). Bounded
        # queues deadlocked on chip (round 4, stack-dump proven): every
        # worker blocked put()ing to the FULL labeled queue while the
        # consumer's parity wanted an unlabeled batch no one was building.
        # With the bound enforced at claim time instead, a worker never
        # blocks holding a built batch, and the wanted stream is always
        # either already built (backlog == cap implies its next seq is
        # among the unconsumed) or claimable (backlog < cap).
        self._queues = {"labeled": queue.Queue()}
        if self.unlabeled:
            self._queues["unlabeled"] = queue.Queue()
        self._capacity = queue_capacity
        self._inflight = {"labeled": 0}
        if self.unlabeled:
            self._inflight["unlabeled"] = 0
        self._backlog_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"loader{i}")
            for i in range(num_threads)
        ]
        self._batch_parity = 0
        # order restoration (same design as mp_loader): builds complete in
        # thread order, but the consumer surfaces them in DRAW order, so the
        # batch stream is deterministic for any num_threads
        self._next_seq = {"labeled": 0}
        self._pending: Dict[str, Dict[int, Dict]] = {"labeled": {}}
        if self.unlabeled:
            self._next_seq["unlabeled"] = 0
            self._pending["unlabeled"] = {}
        if skip_batches:
            fast_forward_streams(
                self.labeled, self.unlabeled, skip_batches
            )
            self._batch_parity = skip_batches
            self._next_seq["labeled"] = self.labeled.count
            if self.unlabeled:
                self._next_seq["unlabeled"] = self.unlabeled.count

    # ------------------------------------------------------------- threads

    def start(self, prefill: bool = False):
        for t in self._threads:
            t.start()
        if prefill:
            import time

            target = self._capacity * len(self._queues)
            while self.queue_depth() < target and self._error is None:
                time.sleep(0.05)
        return self

    def _claim_stream(self) -> Optional[str]:
        """Next stream to build: smallest backlog (queued + in flight +
        consumer-held out-of-order) below capacity; None = everything full
        (mirrors mp_loader._lagging_stream — loader.py:109-115 semantics
        with the capacity bound moved from put() to the claim, which is
        what makes the two-stream pipeline deadlock-free)."""
        with self._backlog_lock:
            backlog = {
                n: self._queues[n].qsize() + self._inflight[n]
                + len(self._pending[n])
                for n in self._queues
            }
            candidates = [
                n for n, b in backlog.items() if b < self._capacity + 1
            ]
            if not candidates:
                return None
            name = min(candidates, key=backlog.get)
            self._inflight[name] += 1
            return name

    def _worker(self):
        import time

        try:
            while not self._stop.is_set():
                name = self._claim_stream()
                if name is None:
                    time.sleep(0.01)
                    continue
                stream = self.labeled if name == "labeled" else self.unlabeled
                # distinct deterministic seed per built batch (drives the
                # per-image scale sampling + RPN label subsampling); drawn
                # from the PER-STREAM schedule (see _Stream.__init__)
                idxs, bseed, seq = stream.next_batch_indices_seeded()
                entries = [stream.roidb[i] for i in idxs]
                built = self.builder.build(entries, seed=bseed)
                batch = built.as_pytree() if hasattr(built, "as_pytree") else built
                # unbounded put: never blocks, releases the claim atomically
                self._queues[name].put((seq, batch))
                with self._backlog_lock:
                    self._inflight[name] -= 1
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            self._error = e
            self._stop.set()

    # ------------------------------------------------------------- consumer

    def get_next_batch(self) -> Dict:
        """Strictly alternate labeled/unlabeled by parity (loader.py:140-146);
        surface batches in draw order (consumer-side reordering)."""
        if self._error is not None:
            raise RuntimeError("loader thread failed") from self._error
        name = "labeled"
        if self.unlabeled:
            name = "labeled" if self._batch_parity % 2 == 0 else "unlabeled"
        self._batch_parity += 1
        want = self._next_seq[name]
        while True:
            if want in self._pending[name]:
                self._next_seq[name] = want + 1
                return self._pending[name].pop(want)
            if self._error is not None:
                raise RuntimeError("loader thread failed") from self._error
            try:
                seq, batch = self._queues[name].get(timeout=1.0)
            except queue.Empty:
                continue
            self._pending[name][seq] = batch

    def queue_depth(self) -> int:
        return sum(q.qsize() for q in self._queues.values()) + sum(
            len(p) for p in self._pending.values()
        )

    def shutdown(self):
        self._stop.set()
        for q in self._queues.values():
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()


class DevicePrefetcher:
    """Host->device double buffering — the BlobsQueue equivalent (ref:
    loader.py:250-273 enqueue threads + caffe2 queue ops): a thread
    device_puts the NEXT host batch (optionally through a shard/transform
    fn) while the current step runs, overlapping H2D transfer with compute.

    Wraps any object with get_next_batch()/queue_depth()/shutdown().
    """

    def __init__(self, loader, transform=None, depth: int = 2):
        import jax

        self._loader = loader
        self._transform = transform or (lambda b: jax.device_put(b))
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="device-prefetch"
        )
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                batch = self._loader.get_next_batch()
                batch = self._transform(batch)
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            self._error = e
            self._stop.set()

    def get_next_batch(self):
        while True:
            # drain already-prefetched good batches before surfacing a
            # worker error (the error belongs to a LATER batch)
            try:
                return self._q.get_nowait()
            except queue.Empty:
                pass
            if self._error is not None:
                raise RuntimeError("device prefetch failed") from self._error
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                continue

    def queue_depth(self) -> int:
        return self._loader.queue_depth() + self._q.qsize()

    def shutdown(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
        self._loader.shutdown()
