"""Host-side batching (the port's copy of starvector_tpu/train/loader.py, with
the process topology passed in rather than read from jax): rasterize+tokenize in worker threads, prefetch ahead
of the device (the reference leans on torch DataLoader workers; here the
C rasterizer releases the GIL through ctypes so threads scale)."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class DataLoader:
    """Batches {'image', 'svg', 'caption', 'id'} samples into device-ready
    arrays: image (B,H,W,3) fp32, svg_ids/svg_mask int32 (right-padded,
    truncated to max_svg_length; eos appended per v1 semantics,
    reference starvector_v1.py:19-22)."""

    def __init__(
        self,
        dataset,
        tokenizer,
        batch_size: int,
        *,
        max_length: int = 512,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        svg_end_suffix: str | None = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        # Deterministic per-epoch permutation: RandomState(seed + epoch), so
        # a resumed run reconstructs the exact batch stream of the
        # uninterrupted one (the reference gets this from DistributedSampler
        # .set_epoch + accelerate.skip_first_batches,
        # reference train/train.py:239-246).
        self.seed = seed
        self.epoch = 0
        self._skip_batches = 0
        # Multi-host: each process feeds a DISJOINT slice of the index space
        # (the reference gets this from torch DistributedSampler via
        # accelerate). The caller passes its process topology (one process
        # by default); batch_size here is the PER-PROCESS batch. The shuffle
        # seed is shared so every host permutes identically before slicing.
        self.process_index = process_index
        self.process_count = process_count
        # v1: svg + eos; v2: svg + <svg-end> + eos (starvector_v2.py:54-58)
        if svg_end_suffix is None:
            svg_end_suffix = (
                (tokenizer.svg_end_token or "") + tokenizer.eos_token
            )
        self.svg_end_suffix = svg_end_suffix

    def set_epoch(self, epoch: int) -> None:
        """Fix the permutation for the next __iter__ (DistributedSampler
        .set_epoch semantics)."""
        self.epoch = int(epoch)

    def skip_first_batches(self, n: int) -> None:
        """Fast-forward the NEXT __iter__ past its first `n` batches without
        collating them (accelerate.skip_first_batches semantics — resume
        mid-epoch re-trains nothing, reference train/train.py:239-246).
        One-shot: cleared when the iterator is built."""
        self._skip_batches = int(n)

    def _local_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.process_count > 1:
            # identical permutation on every host (shared seed), then a
            # strided per-host slice — disjoint, near-equal shards
            order = order[self.process_index::self.process_count]
        return order

    def __len__(self):
        n_local = len(self.dataset)
        if self.process_count > 1:
            n_local = (n_local - self.process_index + self.process_count - 1
                       ) // self.process_count
        n = n_local // self.batch_size
        if not self.drop_last and n_local % self.batch_size:
            n += 1
        return n

    def _collate(self, samples: list[dict]) -> dict:
        texts = [s["svg"] + self.svg_end_suffix for s in samples]
        enc = self.tokenizer(texts, max_length=self.max_length)
        # pad the batch's longest up to a power-of-two bucket: the jitted
        # train step caches compilations BY SHAPE, so "longest" padding
        # would recompile for nearly every batch (minutes each at 8B);
        # bucketing bounds it at ~log2(max_length) compiles while short-SVG
        # batches still avoid full-max_length compute
        L = enc["input_ids"].shape[1]
        bucket = 64
        while bucket < L:
            bucket *= 2
        bucket = min(bucket, self.max_length)
        if bucket > L:
            pad = bucket - L
            pad_id = self.tokenizer.pad_token_id
            if self.tokenizer.padding_side == "left":
                widths = ((0, 0), (pad, 0))
            else:
                widths = ((0, 0), (0, pad))
            enc = {
                "input_ids": np.pad(enc["input_ids"], widths,
                                    constant_values=pad_id),
                "attention_mask": np.pad(enc["attention_mask"], widths),
            }
        return {
            "image": np.stack([np.asarray(s["image"], np.float32) for s in samples]),
            "svg_ids": enc["input_ids"],
            "svg_mask": enc["attention_mask"],
            "caption": [s["caption"] for s in samples],
            "id": [s["id"] for s in samples],
        }

    def __iter__(self) -> Iterator[dict]:
        order = self._local_order()
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self._skip_batches:
            # drop before enqueuing: skipped batches are never rasterized
            batches = batches[self._skip_batches:]
            self._skip_batches = 0

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        idx_q: queue.Queue = queue.Queue()
        for bi, b in enumerate(batches):
            idx_q.put((bi, b))
        results: dict[int, dict] = {}
        lock = threading.Lock()
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self._collate([self.dataset[int(i)] for i in idxs])
                except Exception as e:  # noqa: BLE001
                    batch = e
                # bounded put that re-checks stop: a consumer that closes
                # the generator early (validate()'s max_batches break) must
                # not leave workers blocked forever on a full queue, each
                # pinning a collated image batch
                while not stop.is_set():
                    try:
                        out_q.put((bi, batch), timeout=0.2)
                        break
                    except queue.Full:
                        continue

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(max(1, self.num_workers))
        ]
        for t in threads:
            t.start()
        try:
            next_bi = 0
            received = 0
            while received < len(batches):
                bi, batch = out_q.get()
                received += 1
                with lock:
                    results[bi] = batch
                while next_bi in results:
                    item = results.pop(next_bi)
                    next_bi += 1
                    if isinstance(item, Exception):
                        raise item
                    yield item
        finally:
            stop.set()
