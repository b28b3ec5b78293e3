# -*- coding: utf-8 -*-
"""Batched, prefetched input pipeline feeding NCHW batches to the device. The
port of ``climsr_tpu.data.pipeline``.

Reference ``climsr/core/data.py:19-57`` (torch DataLoader workers): the host
decodes/augments tiles in a thread pool (numpy releases the GIL for the heavy
parts) and collates NHWC numpy batches; :func:`device_prefetch` pins each
batch in a producer thread, copies it to the card on a side stream
(``non_blocking``) one batch ahead, and makes the compute stream wait on the
copy's event. Batches arrive as NCHW tensors viewed from NHWC memory
(``torch.channels_last``), the layout the models take.

- :class:`DataLoader`: shuffled (``np.random.default_rng(seed + epoch)``, the
  JAX order) drop-last train batches; val/test pad the final batch and carry
  an explicit ``__valid__`` count so metric means stay exact.
- :class:`RawTileLoader`: raw normalized {hr, elevation, mask} tiles for the
  device-side augmentation (``ops/augment.py``).
- :func:`build_device_store` / :func:`build_eval_device_store`: the whole tile
  set as tensors on the device, batches gathered there with ``index_select``;
  :class:`EpochIndexSampler` yields the index batches.

The store and the prefetch run on CUDA by default (``device=None``) and take
``device="cpu"``.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

import climsr_tpu_torch.consts as consts
from climsr_tpu_torch.device import DeviceLike, resolve_device

B = consts.batch_items
VALID_KEY = "__valid__"
# val/test sample keys the eval steps never read: not kept on the device
EVAL_STORE_SKIP = ("nearest", "cubic", "elevation_lr")


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if np.ndim(vals[0]) == 0:
            out[key] = np.asarray(vals, dtype=np.float32)
        else:
            out[key] = np.stack(vals)
    return out


def to_nchw(arr: Any) -> torch.Tensor:
    """A numpy array as a tensor without a copy: NHWC (4-D) viewed as NCHW
    (``torch.channels_last``), anything else as it is."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.permute(0, 3, 1, 2) if t.ndim == 4 else t


class DataLoader:
    """Minimal epoch-based loader: shuffling sampler + threaded decode + collate."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: Optional[bool] = None,
        num_workers: int = 8,
        seed: int = 42,
        pad_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.pad_last = pad_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        # datasets with per-sample augmentation derive their RNG from
        # (seed+epoch, index) so threaded decode stays order-independent
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.seed + epoch)

    def order(self) -> np.ndarray:
        """This epoch's sample order (the JAX loader's)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = self.order()
        end = (n // self.batch_size) * self.batch_size if self.drop_last else n
        batches = [order[start: start + self.batch_size] for start in range(0, end, self.batch_size)]
        for samples in _threaded(batches, self.dataset.__getitem__, self.num_workers):
            batch = collate(samples)
            n_valid = len(samples)
            if self.pad_last and n_valid < self.batch_size:
                pad = self.batch_size - n_valid
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) for k, v in batch.items()}
            batch[VALID_KEY] = np.asarray(n_valid, dtype=np.int32)
            yield batch


def _threaded(batches, fetch, num_workers: int):
    """The fetched samples of each index batch, in order, two batches in flight."""
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = collections.deque()
        batch_iter = iter(batches)
        for _ in range(2):
            idxs = next(batch_iter, None)
            if idxs is not None:
                pending.append(pool.map(fetch, idxs))
        while pending:
            samples = list(pending.popleft())
            idxs = next(batch_iter, None)
            if idxs is not None:
                pending.append(pool.map(fetch, idxs))
            yield samples


def _raw_tiles(tiles) -> Dict[str, np.ndarray]:
    """(hr, elev, mask, ...) tuples -> stacked NHWC {hr, elevation, mask} float32."""
    return {
        B.hr: np.stack([t[0] for t in tiles])[..., None],
        B.elevation: np.stack([t[1] for t in tiles])[..., None],
        B.mask: np.stack([t[2] for t in tiles]).astype(np.float32)[..., None],
    }


class RawTileLoader:
    """Serves batches of raw normalized tiles {hr, elevation, mask} for
    device-side augmentation (ops/augment.py).

    Bypasses per-sample augmentation/resize entirely: after the first epoch
    the dataset's in-RAM tile cache makes a batch a pure stack of cached
    arrays.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 8, seed: int = 42):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        batches = [order[s: s + self.batch_size] for s in range(0, len(self) * self.batch_size, self.batch_size)]
        for samples in _threaded(batches, lambda i: self.dataset._load_normalized(int(i)), self.num_workers):
            yield _raw_tiles(samples)


def _load_all(fetch, n: int, num_workers: int) -> list:
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        return list(pool.map(fetch, range(n)))


def build_device_store(dataset, num_workers: int = 8, dtype: Optional[torch.dtype] = None,
                       device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The whole tile set on the device: {hr, elevation, mask}, each
    (n_tiles, 1, H, W) float32 (or ``dtype``). One bulk copy replaces the
    per-step batch copies; about 200 KB a 128x128 tile (all three rasters)."""
    dev = resolve_device(device)
    raw = _raw_tiles(_load_all(dataset._load_normalized, len(dataset), num_workers))
    return {k: to_nchw(v).to(device=dev, dtype=dtype or torch.float32).contiguous() for k, v in raw.items()}


def build_eval_device_store(dataset, num_workers: int = 8, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The val/test sample dicts stacked on the device (NCHW, channels_last
    for the 4-D ones), less the keys the eval step never reads
    (``EVAL_STORE_SKIP``). Batches are gathered on the device by index."""
    dev = resolve_device(device)
    samples = _load_all(dataset.__getitem__, len(dataset), num_workers)
    keep = [k for k in samples[0] if k not in EVAL_STORE_SKIP]
    batch = collate([{k: s[k] for k in keep} for s in samples])
    return {k: to_nchw(v).to(dev) for k, v in batch.items()}


def gather(store: Dict[str, torch.Tensor], indices: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Rows ``indices`` of every tensor of a device store (``index_select`` on dim 0)."""
    return {k: v.index_select(0, indices) for k, v in store.items()}


class EpochIndexSampler:
    """Shuffled drop-last epoch index batches (the DataLoader's sampling, minus data)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True, seed: int = 42):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return self.n // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            yield np.asarray(order[start: start + self.batch_size], np.int64)


def device_prefetch(
    iterator: Iterator[Dict[str, np.ndarray]],
    device: DeviceLike = None,
    prefetch: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches -> NCHW tensors on ``device`` (``None`` means ``cuda``), one batch ahead.

    On CUDA a producer thread pins each batch (page-locked host copies) and
    queues at most ``prefetch`` of them; the consumer issues the next batch's
    ``non_blocking`` copies on a side stream while the current one computes,
    and the compute stream waits on the copy's event before reading it. On
    the CPU the batches are only viewed as tensors. Abandoning the generator
    early (limits, max_steps, preemption) releases the producer.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in iterator:
            yield {k: to_nchw(v) for k, v in batch.items()}
        return

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put({k: to_nchw(v).pin_memory() for k, v in batch.items()}):
                    return
        except Exception as e:  # propagate into the consumer
            err.append(e)
        finally:
            put(sentinel)

    side = torch.cuda.Stream(device=dev)

    def issue():
        host = q.get()
        if host is sentinel:
            if err:
                raise err[0]
            return None
        with torch.cuda.stream(side):
            on_dev = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return on_dev, ready

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        nxt = issue()
        while nxt is not None:
            on_dev, ready = nxt
            nxt = issue()
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(ready)
            for v in on_dev.values():
                v.record_stream(compute)
            yield on_dev
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
