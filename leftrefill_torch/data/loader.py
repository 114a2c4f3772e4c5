"""The host input pipeline (counterpart of ``leftrefill_tpu/data/loader.py``,
numpy copies): tokenization of the prompts, collation into numpy batches,
the multi-view flattening, and a threaded, epoch-aware loader with a
prefetch queue."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


def tokenize_txt(tokenizer, txt) -> np.ndarray:
    """A string -> [77] ids; a list of strings (per-layer or per-view
    prompts) -> [L, 77]."""
    if isinstance(txt, str):
        return tokenizer.tokenize(txt)[0]
    return tokenizer.tokenize(list(txt))


def collate(items: Sequence[dict], tokenizer=None) -> dict:
    """Stack the dataset's dicts into one numpy batch; "txt" becomes
    "tokens" when a tokenizer is given (each distinct prompt of the batch
    tokenized once: a batch's prompts mostly repeat)."""
    out: dict[str, Any] = {}
    for k in items[0].keys():
        vals = [it[k] for it in items]
        if k == "txt":
            if tokenizer is not None:
                keys = [v if isinstance(v, str) else tuple(v) for v in vals]
                ids: dict = {}
                for key, v in zip(keys, vals):
                    if key not in ids:
                        ids[key] = tokenize_txt(tokenizer, v)
                out["tokens"] = np.stack([ids[key] for key in keys])
            else:
                out["txt"] = vals
        elif isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[k] = np.stack([np.asarray(v) for v in vals])
        else:
            out[k] = vals
    return out


def flatten_views(batch: dict) -> dict:
    """A multi-view batch (B, V, H, W, C) -> (B*V, H, W, C), its tokens
    (B, V, 77) -> (B*V, 77): each scene's V views become consecutive rows,
    the layout the multi-view UNet folds.  Other entries are kept as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 3:
            out[k] = v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])
        else:
            out[k] = v
    return out


class DataLoader:
    """Sampler indices (or the dataset's, shuffled per epoch with
    ``RandomState(seed + epoch)``) -> ``__getitem__`` on ``num_workers``
    threads -> :func:`collate` -> a queue of ``prefetch`` batches filled by
    a producer thread.

    ``shard`` (rank, world) splits each batch over the ranks of a node (JAX's
    per-host batch, sharded over the local devices): a batch is ``world *
    batch_size`` items of the one index order every rank shares, and the
    rank gets its contiguous ``batch_size`` of them.  Every rank reads all
    the items: a dataset draws its crops and masks from one stream in item
    order, so a rank that read only its own would draw other ones than the
    single-process loader gives those items."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        sampler: Optional[Iterable[int]] = None,
        tokenizer=None,
        shuffle: bool = False,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        if shard[1] > 1 and not drop_last:
            raise ValueError("a loader split over ranks drops the last, partial batch (drop_last=True)")
        self.shard = shard
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _indices(self) -> list[int]:
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        size = self.batch_size * self.shard[1]
        return n // size if self.drop_last else -(-n // size)

    def __iter__(self) -> Iterator[dict]:
        indices = self._indices()
        rank, world = self.shard
        size = self.batch_size * world
        if self.drop_last:
            indices = indices[: len(indices) // size * size]
        batches = [indices[i: i + size] for i in range(0, len(indices), size)]
        mine = slice(rank * self.batch_size, (rank + 1) * self.batch_size)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, batch_idx))
                        q.put(collate(items[mine], self.tokenizer))
                q.put(None)
            except Exception as e:  # handed to the consumer, which raises it
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is None:
                    break
                if isinstance(b, Exception):
                    raise b
                yield b
        finally:  # a consumer that stops early: the producer ends after its current batch
            stop.set()
            while not q.empty():
                q.get_nowait()
