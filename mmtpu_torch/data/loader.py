"""Fixed-shape batch loader with background prefetch (own copy of
`BatchLoader`, mmtpu/data/loader.py, numpy gather path only).

Every batch has the same shapes: partial tail batches are zero-padded and
carry `sample_mask`; per-modality keep-masks ride along as (B,) vectors
multiplied in on the device. Batches are NHWC numpy, byte-identical to the
ones mmtpu's loader emits for the same dataset.

Batch schema:
    {mod}:        raw modality array (B, ...)
    {mod}_mask:   keep-mask (B,) float32
    {mod}_lengths: (B,) int32, for datasets that carry per-sample lengths
    labels:       (B,) or (B, C)
    sample_idx:   (B,) int32 — source row (0 for padded rows)
    pattern_id:   (B,) int32 into dataset.pattern_vocab()
    sample_mask:  (B,) float32 — 0 for padded rows
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from mmtpu_torch.data.base import MultimodalArrayDataset
from mmtpu_torch.modalities import Modality

PREFETCH = 2  # batches assembled ahead of the consumer


def _gather(arr: np.ndarray, idx_pad: np.ndarray) -> np.ndarray:
    """arr[idx_pad] with zero rows where idx_pad < 0 (tail padding)."""
    out = arr[np.clip(idx_pad, 0, arr.shape[0] - 1)]
    out[idx_pad < 0] = 0
    return out


def _keep_mask(m: np.ndarray, pids: np.ndarray, idx_pad: np.ndarray) -> np.ndarray:
    """float32 mask_stack[pids, idx_pad], 0 for padding rows."""
    keep = m[pids, np.clip(idx_pad, 0, m.shape[1] - 1)].astype(np.float32)
    keep[idx_pad < 0] = 0.0
    return keep


class BatchLoader:
    def __init__(
        self,
        dataset: MultimodalArrayDataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def pattern_vocab(self) -> List[str]:
        return self.dataset.pattern_vocab()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Batches are assembled on a worker thread, PREFETCH ahead."""
        it = self._epoch_batches()
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        sentinel = object()
        error: List[BaseException] = []
        cancel = threading.Event()

        def put(item) -> None:
            # cancel-aware put: a consumer that abandoned the epoch must not
            # leave the worker blocked on a full queue
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            try:
                for b in it:
                    put(b)
                    if cancel.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
                error.append(e)
            finally:
                put(sentinel)  # never dropped, or the consumer deadlocks

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
            if error:
                raise error[0]
        finally:
            cancel.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=2.0)
            self.epoch += 1

    def _epoch_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        ds = self.dataset
        mods = list(ds.AVAILABLE_MODALITIES.values())
        vocab = ds.pattern_vocab()

        if ds.split == "train":
            order = np.arange(ds.num_samples)
            if self.shuffle:
                rng = np.random.default_rng((self.seed, self.epoch, 0x5EED))
                rng.shuffle(order)
            pattern_idx = ds.train_schedule(self.epoch)
            sample_idx = order
            pattern_of = pattern_idx[order]
        else:
            # pattern-major deterministic blocks: (pattern, sample) product
            n = ds.num_samples
            sample_idx = np.tile(np.arange(n), len(vocab))
            pattern_of = np.repeat(np.arange(len(vocab)), n)

        total = sample_idx.shape[0]
        bs = self.batch_size
        n_batches = total // bs if self.drop_last else -(-total // bs)

        for b in range(n_batches):
            sl = slice(b * bs, (b + 1) * bs)
            idx = sample_idx[sl]
            pids = pattern_of[sl]
            real = idx.shape[0]
            if real < bs:  # fixed shapes: pad the index vectors, not arrays
                idx = np.concatenate([idx, np.full(bs - real, -1, idx.dtype)])
                pids = np.concatenate([pids, np.zeros(bs - real, pids.dtype)])
            batch: Dict[str, np.ndarray] = {}
            for mod in mods:
                if ds.target_modality not in (Modality.MULTIMODAL, mod):
                    continue
                batch[str(mod)] = _gather(ds.arrays[mod], idx)
                batch[f"{mod}_mask"] = _keep_mask(
                    ds.mask_stack(mod, np.uint8), pids, idx
                )
                lengths = getattr(ds, "lengths", {}).get(mod)
                if lengths is not None:
                    batch[f"{mod}_lengths"] = _gather(lengths, idx)
            batch["labels"] = _gather(ds.labels, idx)
            batch["sample_idx"] = np.maximum(idx, 0).astype(np.int32)
            batch["pattern_id"] = pids.astype(np.int32)
            batch["sample_mask"] = (idx >= 0).astype(np.float32)
            yield batch


def build_loader(dataset: MultimodalArrayDataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0) -> BatchLoader:
    return BatchLoader(dataset, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
                       seed=seed)


class DevicePrefetcher:
    """Wrap a BatchLoader: each batch's arrays on the device (this rank's
    rows under a launched `mesh`), copied one batch ahead of the consumer
    (mmtpu's `DevicePrefetcher`). `device` defaults to the mesh rank's, else
    the card. `transfer_dtype` ("bfloat16") halves the copy of the float32
    arrays named in `transfer_keys` (opt-in: some float32 payloads carry
    integer content, BERT token ids, that bfloat16 would corrupt)."""

    def __init__(self, loader: BatchLoader, mesh=None, transfer_dtype=None,
                 transfer_keys=None, device=None) -> None:
        import torch

        self.loader = loader
        self.mesh = mesh
        self.transfer_dtype = transfer_dtype
        self.transfer_keys = set(transfer_keys or ())
        self.device = torch.device(device if device is not None else
                                   mesh.device if mesh is not None else "cuda")

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def pattern_vocab(self):
        return self.loader.pattern_vocab

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        import torch

        from mmtpu_torch.parallel.mesh import shard_batch

        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        dtype = None
        if self.transfer_dtype is not None and self.transfer_keys:
            dtype = (torch.bfloat16 if self.transfer_dtype in ("bfloat16", "bf16")
                     else getattr(torch, str(self.transfer_dtype)))
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if dtype is not None and k in self.transfer_keys and t.dtype == torch.float32:
                t = t.to(dtype)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        prev: Optional[Dict[str, Any]] = None
        for host_batch in self.loader:
            nxt = self._put(host_batch)
            if prev is not None:
                yield prev
            prev = nxt
        if prev is not None:
            yield prev
