"""Dataset builder and loaders.

The port's own copy of the loader in ``toda_tpu/datasets/__init__.py``: a
host loader with static-shape numpy collation and a background
thread that prepares the next batches while the device runs. The model entry
points move the numpy batches to their device. In a data-parallel run each
rank reads the frames ``indices[rank::world]`` of the index list padded to a
multiple of the world size (:59-67, 158-166), so every rank takes the same
number of steps. ``build_cutmix_dataloader`` and ``build_mixup_dataloader``
are the TODA stages' loaders (:175-189). ``build_dataset`` knows the
synthetic scenes, nuScenes, Waymo, KITTI and the two mixing datasets; Lyft
and Pandaset are not ported yet.
"""

import pickle
import queue
import threading

import numpy as np

from ..parallel.mesh import get_dist_info
from .synthetic.synthetic_dataset import SyntheticDataset


class DataLoader:
    """Minimal loader over a DatasetTemplate.

    Test mode: frames in order, the last batch filled up with the first
    frames. Training: frames in the permutation of ``RandomState(epoch)``
    (the JAX loader's at seed 0; ``set_epoch`` moves it on), the last
    partial batch dropped. With ``world_size`` > 1 the rank takes every
    world-th frame from its rank on, of the list padded with its own head
    to a multiple of the world size. prefetch > 0 runs __getitem__ +
    collate on a background thread with a bounded queue, overlapping host
    preprocessing with the device step.
    """

    def __init__(self, dataset, batch_size, training=False, prefetch=2, rank=0,
                 world_size=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.training = training
        self.prefetch = prefetch
        self.rank, self.world_size = rank, world_size
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        idx = np.random.RandomState(self.epoch).permutation(n) if self.training \
            else np.arange(n)
        if self.world_size > 1:
            idx = np.concatenate([idx, idx[:(-n) % self.world_size]])
            idx = idx[self.rank::self.world_size]
        return idx

    def __len__(self):
        n = -(-len(self.dataset) // self.world_size)
        if self.training:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

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


def build_dataset(dataset_cfg, class_names, training=False, root_path=None, logger=None,
                  **kwargs):
    name = dataset_cfg.DATASET
    if name == "SyntheticDataset":
        cls = SyntheticDataset
    elif name == "NuScenesDataset":
        from .nuscenes.nuscenes_dataset import NuScenesDataset as cls
    elif name == "WaymoDataset":
        from .waymo.waymo_dataset import WaymoDataset as cls
    elif name == "KittiDataset":
        from .kitti.kitti_dataset import KittiDataset as cls
    elif name in ("CutMixDataset", "MixUpDataset"):
        from . import mix_dataset

        cls = getattr(mix_dataset, name)
    else:
        raise KeyError(f"dataset {name} is not ported to the PyTorch package yet")
    return cls(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
               root_path=root_path, logger=logger, **kwargs)


def build_dataloader(dataset_cfg, class_names, batch_size, dist=False, root_path=None,
                     workers=0, logger=None, training=False, **dataset_kwargs):
    """Returns (dataset, dataloader, sampler_like) like ``toda_tpu``'s
    (training: shuffled, last partial batch dropped). With ``dist`` the
    loader takes this process's rank-strided share (``batch_size`` is then
    the per-rank batch). ``dataset_kwargs`` go to the dataset
    (``pseudo_infos`` of a MixUpDataset)."""
    dataset = build_dataset(dataset_cfg, class_names, training, root_path, logger,
                            **dataset_kwargs)
    rank, world = get_dist_info() if dist else (0, 1)
    loader = DataLoader(dataset, batch_size=batch_size, training=training,
                        prefetch=workers if workers > 0 else 2, rank=rank, world_size=world)
    return dataset, loader, loader


def build_cutmix_dataloader(dataset_cfg, class_names, batch_size, **kwargs):
    """The stage-1 loader: a CutMixDataset config's."""
    return build_dataloader(dataset_cfg, class_names, batch_size, **kwargs)


def build_mixup_dataloader(dataset_cfg, class_names, batch_size, pseudo_infos=None, **kwargs):
    """The stage-2 loader: a MixUpDataset config's, over ``pseudo_infos``
    (a list, or the path of its pickle)."""
    if isinstance(pseudo_infos, (str, bytes)):
        with open(pseudo_infos, "rb") as f:
            pseudo_infos = pickle.load(f)
    return build_dataloader(dataset_cfg, class_names, batch_size, pseudo_infos=pseudo_infos,
                            **kwargs)
