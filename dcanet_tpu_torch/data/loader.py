"""Host-side batching and device prefetch (port of dcanet_tpu/data/loader.py).

  * `Loader`: epoch-seeded shuffling, thread-pool decode, fixed-shape
    batches of numpy arrays, the next batch assembled while the current one
    is consumed.
  * `device_prefetch`: the torch twin of the JAX package's device_prefetch
    (loader.py:157-194): batches become tensors on the device `depth` steps
    ahead, copied from pinned host memory on a side CUDA stream, so the copy
    overlaps the step that runs.

Eval padding is `data/submission.py::pad_to_multiple` and the per-dataset
eval geometry `data/eval_protocol.py::eval_transform`; per-host sharding
waits for the multi-process slice of the port.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


class Loader:
    """Iterates fixed-shape batches with background decode.

    dataset: StereoDataset-like (len + __getitem__ -> dict of arrays). All
    samples of a batch must share shapes (training crops do; for eval use
    batch_size=1 or pre-padded datasets).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(self.seed + epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self.epoch).permutation(indices)
        nb = len(self)
        # two pools: `batch_pool` assembles the next batch while the caller
        # consumes the current one; `decode_pool` decodes its samples (one
        # shared pool would deadlock: a fetch would starve its own map)
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as decode_pool, \
                cf.ThreadPoolExecutor(max_workers=1) as batch_pool:

            def fetch(bi):
                batch_idx = indices[bi * self.batch_size : (bi + 1) * self.batch_size]
                samples = list(decode_pool.map(self.dataset.__getitem__, batch_idx))
                return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

            pending = None
            for bi in range(nb):
                fut = batch_pool.submit(fetch, bi)
                if pending is not None:
                    yield pending.result()
                pending = fut
            if pending is not None:
                yield pending.result()


def device_prefetch(
    iterator: Iterable[Dict[str, np.ndarray]], device: torch.device, depth: int = 2
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of numpy arrays -> dicts of tensors on `device`, `depth` ahead.

    On CUDA each batch is copied into pinned host memory and sent with
    non-blocking copies on a side stream; the consumer's stream waits on the
    copy's event before the batch is handed over, and the tensors are
    recorded on that stream so their memory is not reused too early. On the
    CPU the arrays are wrapped as they are.
    """
    device = torch.device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield {k: torch.from_numpy(v) for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device)
    queue = collections.deque()

    def put(batch):
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True) for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    for batch in it:
        queue.append(put(batch))
        if len(queue) >= depth:
            break
    while queue:
        out, ready = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(ready)
        for t in out.values():
            t.record_stream(consumer)
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        yield out
