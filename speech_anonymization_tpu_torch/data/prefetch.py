"""Background-prefetching data loader.

Counterpart of ``speech_anonymization_tpu/data/prefetch.py``, a copy. The
heavy lifting (WAV/FLAC decode) runs in the native C++ library, which
releases the GIL inside ctypes calls, so a thread pool gives real parallelism
without process-fork overhead, and a bounded queue keeps
``prefetch_batches`` batches ready while the card consumes the previous step.
The batches, and their order, are the wrapped loader's.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

_SENTINEL = object()


class PrefetchLoader:
    """Wrap any batch iterable; materialize batches ahead of consumption."""

    def __init__(self, loader: Iterable, prefetch_batches: int = 2, num_threads: int = 4):
        self.loader = loader
        self.prefetch_batches = prefetch_batches
        self.num_threads = num_threads

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def state_dict(self):
        return self.loader.state_dict() if hasattr(self.loader, "state_dict") else {}

    def load_state_dict(self, d):
        if hasattr(self.loader, "load_state_dict"):
            self.loader.load_state_dict(d)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        error: list[BaseException] = []

        def producer():
            try:
                if self.num_threads > 1 and hasattr(self.loader, "dataset") and hasattr(
                    self.loader, "batch_size"
                ):
                    self._parallel_produce(q)
                else:
                    for batch in self.loader:
                        q.put(batch)
            except BaseException as e:  # propagate to consumer
                error.append(e)
            finally:
                q.put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        thread.join()
        if error:
            raise error[0]

    def _parallel_produce(self, q: queue.Queue):
        """Decode items with a thread pool, collate in order."""
        import numpy as np

        loader = self.loader
        dataset = loader.dataset
        order = np.arange(len(dataset))
        if getattr(loader, "shuffle", False):
            rng = np.random.default_rng(loader.seed + loader.epoch)
            rng.shuffle(order)
        n_batches = len(loader)
        with ThreadPoolExecutor(self.num_threads) as pool:
            for b in range(n_batches):
                idx = order[b * loader.batch_size : (b + 1) * loader.batch_size]
                if loader.drop_last and len(idx) < loader.batch_size:
                    break
                items = list(pool.map(lambda i: dataset[int(i)], idx))
                q.put(loader.collate_fn(items))
