"""Online-serving micro-batcher: single requests → padded batches (own copy
of `mmtpu/serving/batcher.py`).

Requests enqueue; a worker thread groups them (up to `max_batch` or
`max_wait_ms`, whichever first), pads the group to the next power-of-two
bucket, runs the predict function once, and resolves each request's Future
with its row slice. On the GPU the buckets keep the set of batch shapes
small (cuDNN picks one algorithm per shape); the kernel and the encoders
see one launch per group instead of one per request.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np


def _next_bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class MicroBatcher:
    def __init__(
        self,
        predict_fn: Callable[..., Dict[str, Any]],
        input_keys: Sequence[str],
        *,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        input_shapes: Optional[Dict[str, Sequence[int]]] = None,
    ) -> None:
        """input_shapes: optional {key: trailing dims} contract. When set,
        submit() rejects mis-shaped samples up front — otherwise one
        malformed request would fail np.stack for its whole group."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.predict_fn = predict_fn
        self.input_keys = tuple(str(k) for k in input_keys)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.input_shapes = (
            {str(k): tuple(v) for k, v in input_shapes.items()}
            if input_shapes else None
        )
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "rows": 0, "padded_rows": 0}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, sample: Dict[str, Any]) -> Future:
        """Enqueue one UNBATCHED sample ({input_key: array}); returns a
        Future resolving to {output_key: row} (no batch dim)."""
        missing = [k for k in self.input_keys if k not in sample]
        if missing:
            raise KeyError(f"sample missing inputs {missing}")
        if self.input_shapes:
            for key, want in self.input_shapes.items():
                got = np.shape(sample[key])
                if tuple(got) != want:
                    raise ValueError(
                        f"input {key!r} has shape {tuple(got)}, expected {want}"
                    )
        fut: Future = Future()
        # the closed-check and the enqueue are atomic against close(), so
        # nothing is enqueued after the worker's final drain
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((sample, fut))
        return fut

    def close(self) -> None:
        """Drain outstanding requests, then stop the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # sentinel — ordered after every accepted put
        self._worker.join()

    def _collect(self):
        """Block for the first request, then gather until max_batch or the
        wait window closes. Returns (group, saw_sentinel)."""
        first = self._q.get()
        if first is None:
            return [], True
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                return group, True
            group.append(item)
        return group, False

    def _run(self) -> None:
        while True:
            group, done = self._collect()
            if group:
                self._process(group)
            if done:
                leftovers = []
                while True:
                    try:
                        item = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if item is not None:
                        leftovers.append(item)
                for i in range(0, len(leftovers), self.max_batch):
                    self._process(leftovers[i : i + self.max_batch])
                return

    def _process(self, group) -> None:
        samples = [s for s, _ in group]
        futures = [f for _, f in group]
        n = len(samples)
        bucket = _next_bucket(n, self.max_batch)
        try:
            inputs = []
            for key in self.input_keys:
                rows = np.stack([np.asarray(s[key]) for s in samples])
                if bucket > n:  # pad with the first row (shape-only filler)
                    pad = np.broadcast_to(rows[:1], (bucket - n,) + rows.shape[1:])
                    rows = np.concatenate([rows, pad])
                inputs.append(rows)
            out = self.predict_fn(*inputs)
            out = {k: np.asarray(v) for k, v in out.items()}
            for i, fut in enumerate(futures):
                fut.set_result({k: v[i] for k, v in out.items()})
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["rows"] += n
            self.stats["padded_rows"] += bucket - n
        except Exception as e:  # noqa: BLE001 — resolve every waiter; server stays up
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
