"""Prefetching data loader: a jax-free copy of
`aigv_assessor_tpu/data/loader.py`.

One producer thread collates batches in the sampler's order while a pool of
`num_workers` threads decodes their samples (video decode releases the GIL
in OpenCV / ffmpeg), `prefetch` batches ahead of the consumer; numpy
batches, which the caller moves to its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

from aigv_assessor_torch.data.collator import Batch, collate


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_sampler,
        pad_to: Optional[int] = None,
        num_workers: int = 2,
        prefetch: int = 2,
        collate_fn: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.pad_to = pad_to
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate_fn = collate_fn or (lambda s: collate(s, pad_to=self.pad_to))

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def __iter__(self) -> Iterator[Batch]:
        if self.num_workers <= 1:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])
            return
        yield from self._threaded_iter()

    def _threaded_iter(self) -> Iterator[Batch]:
        batches = list(self.batch_sampler)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # never block forever on a full queue: if the consumer abandons
            # iteration early (exception in the train step, break), the
            # generator's finally sets `stop` while this thread would be
            # stuck in a blocking put — leaking the thread and its decode
            # pool for process lifetime
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            # one producer thread keeps ordering deterministic; per-sample
            # decode parallelism happens inside via a small pool
            from concurrent.futures import ThreadPoolExecutor

            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, idxs))
                        if not put(self.collate_fn(samples)):
                            return
            except Exception as e:  # surface loader errors to the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
