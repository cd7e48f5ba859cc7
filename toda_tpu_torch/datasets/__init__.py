"""Dataset builder and loader.

The port's own copy of the loader in ``toda_tpu/datasets/__init__.py``: a
host loader with static-shape numpy collation and a background
thread that prepares the next batches while the device runs. The model entry
points move the numpy batches to their device. Single process: the
rank-strided distributed loader comes with the distributed-runtime slice.
"""

import queue
import threading

import numpy as np

from .synthetic.synthetic_dataset import SyntheticDataset


class DataLoader:
    """Minimal loader over a DatasetTemplate.

    Test mode: frames in order, the last batch filled up with the first
    frames. Training: frames in the permutation of ``RandomState(0)`` (the
    JAX loader's at seed 0, epoch 0), the last partial batch dropped.
    prefetch > 0 runs __getitem__ + collate on a background thread with a
    bounded queue, overlapping host preprocessing with the device step.
    """

    def __init__(self, dataset, batch_size, training=False, prefetch=2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.training = training
        self.prefetch = prefetch

    def _indices(self):
        n = len(self.dataset)
        if self.training:
            return np.random.RandomState(0).permutation(n)
        return np.arange(n)

    def __len__(self):
        if self.training:
            return len(self.dataset) // self.batch_size
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _make_batch(self, idx, b):
        chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
        if len(chunk) < self.batch_size:
            chunk = np.concatenate([chunk, idx[: self.batch_size - len(chunk)]])
        samples = [self.dataset[int(i)] for i in chunk]
        return self.dataset.collate_batch(samples)

    def __iter__(self):
        idx = self._indices()
        nb = len(self)
        if self.prefetch <= 0 or nb <= 1:
            for b in range(nb):
                yield self._make_batch(idx, b)
            return

        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def worker():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    q.put(self._make_batch(idx, b))
            except BaseException as e:  # surfaced on the consumer side
                q.put(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early must not leave the worker blocked
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def build_dataset(dataset_cfg, class_names, training=False, root_path=None, logger=None):
    name = dataset_cfg.DATASET
    if name != "SyntheticDataset":
        raise KeyError(f"dataset {name} is not ported to the PyTorch package yet")
    return SyntheticDataset(dataset_cfg=dataset_cfg, class_names=class_names,
                            training=training, root_path=root_path, logger=logger)


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False, root_path=None,
                     workers=0, logger=None, training=False):
    """Returns (dataset, dataloader, sampler_like) like ``toda_tpu``'s
    (training: shuffled, last partial batch dropped)."""
    if dist:
        raise NotImplementedError("the distributed loader is not ported yet")
    dataset = build_dataset(dataset_cfg, class_names, training, root_path, logger)
    loader = DataLoader(dataset, batch_size=batch_size, training=training,
                        prefetch=workers if workers > 0 else 2)
    return dataset, loader, loader
