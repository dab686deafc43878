"""Sharded shuffling sampler and threaded batch loader (numpy batches).

Port of `vist3a_tpu/data/loader.py` (the reference's
`data/dataset_util.py`): the name → class registry and `(name, root)`
dataset pairs (:12-42), a ConcatDataset over several, the
`DistributedSampler(seed=22, shuffle=True)` semantics (:69-75: padded to a
multiple of the world size, `rank::world` strides, reseeded each epoch), 3
workers, drop_last batching (:76-86), and the VDM pair: a batch-1 prompt
loader and the DL3DV clip loader (:96-133).

As in the JAX package the permutation comes from numpy PCG64, not torch's
`randperm`: the shards are disjoint and deterministic, the order is not
torch's.  Every draw (the permutation, each sample's `PCG64((seed, epoch,
index))`) is the JAX package's, so the batches are its batches.  Batches
are numpy; the training loops move them to their device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from vist3a_tpu_torch.data import datasets as ds


class ShardedSampler:
    """Epoch-deterministic shuffled shard of [0, len) for one data-parallel
    rank (DistributedSampler parity: pad to a multiple of num_replicas by
    wrapping, then take rank::num_replicas)."""

    def __init__(self, num_samples: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 22):
        self.num_samples = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.Generator(
                np.random.PCG64(self.seed + self.epoch))
            order = rng.permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        per = -(-self.num_samples // self.num_replicas)
        total = per * self.num_replicas
        if total > len(order):                     # wrap-pad
            order = np.concatenate([order, order[: total - len(order)]])
        return order[self.rank::self.num_replicas]

    def __len__(self):
        return -(-self.num_samples // self.num_replicas)


def _collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class BatchLoader:
    """Threaded prefetching loader.  Per-sample numpy rngs are derived from
    (seed, epoch, index) — the functional replacement for the reference's
    process-global `random` in workers."""

    def __init__(self, dataset, batch_size: int, sampler: ShardedSampler,
                 *, num_workers: int = 3, drop_last: bool = True,
                 seed: int = 22):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.seed = seed
        self._skip = 0

    def skip_first_batches(self, n: int):
        """Resume mid-epoch: the NEXT `__iter__` drops its first n batches
        (accelerate `skip_first_batches` parity, `train_vdm.py:475-487` —
        but skipped batches are never loaded, only their indices dropped)."""
        self._skip = int(n)
        return self

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _sample(self, idx: int) -> dict:
        rng = np.random.Generator(np.random.PCG64(
            (self.seed, self.sampler.epoch, int(idx))))
        return self.dataset.get(int(idx), rng)

    def __iter__(self):
        indices = self.sampler.indices()
        n_batches = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_batches)]
        if self._skip:
            batches = batches[self._skip:]
            n_batches = len(batches)
            self._skip = 0

        job_q: "queue.Queue" = queue.Queue()
        results: dict[int, dict] = {}
        errors: list[BaseException] = []
        lock = threading.Lock()

        for bi, batch in enumerate(batches):
            job_q.put((bi, batch))

        def worker():
            while True:
                try:
                    bi, batch = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    samples = [self._sample(i) for i in batch]
                except Exception as e:  # noqa: BLE001 — re-raised below
                    with lock:
                        errors.append(e)
                    return
                with lock:
                    results[bi] = _collate(samples)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        served = 0
        while served < n_batches:
            with lock:
                ready = served in results
                if errors and not ready:
                    # a worker's failure ends the pass (the JAX loader
                    # would wait for the batch forever)
                    raise errors[0]
            if ready:
                with lock:
                    yield results.pop(served)
                served += 1
            else:
                threading.Event().wait(0.005)


# --------------------------------------------------------------------------- #
# factories (`data/dataset_util.py:45-133`)                                   #
# --------------------------------------------------------------------------- #
_STITCHING_REGISTRY = {
    "dl3dv": ds.DL3DVStitchingDataset,
    "scannet": ds.ScannetUnlabeledDataset,
}


def create_stitching_dataloader(datasets, args, *, augmentation=False,
                                num_replicas=1, rank=0):
    """datasets: list of (name, root) pairs — same token format as the
    reference CLI (`NAME:PATH`)."""
    objs = []
    for name, root in datasets:
        cls = _STITCHING_REGISTRY.get(name)
        if cls is None:
            raise ValueError(f"Unknown dataset name: {name}")
        objs.append(cls(
            root_path=root,
            num_images_from_unit_scene=args.num_images_from_unit_scene,
            num_frames_per_unit_scene=args.num_frames_per_unit_scene,
            image_resolution=args.resolution,
            feedforward_image_resolution=args.feedforward_resolution,
            color_augmentation=augmentation))
    train_set = objs[0] if len(objs) == 1 else ds.ConcatDataset(objs)
    sampler = ShardedSampler(len(train_set), num_replicas, rank,
                             shuffle=True, seed=22)
    loader = BatchLoader(train_set, args.batch_size, sampler,
                         num_workers=3, drop_last=True)
    return loader, sampler


def create_vdm_tuning_dataloader(datasets, args, *, num_replicas=1, rank=0):
    text_loader = dl3dv_loader = None
    for name, root in datasets:
        if name == "text":
            tset = ds.TextPromptDataset(root)
            text_loader = BatchLoader(
                tset, 1, ShardedSampler(len(tset), 1, 0, shuffle=False),
                num_workers=1, drop_last=False)
        elif name == "dl3dv":
            dset = ds.DL3DVTextPairedDataset(
                root_path=root,
                num_images_from_unit_scene=args.num_images_from_unit_scene,
                num_frames_per_unit_scene=args.num_frames_per_unit_scene,
                image_resolution=args.resolution,
                text_annotation_path=getattr(
                    args, "text_annotation_path",
                    "data/dl3dv_text_label_980P.json"))
            dl3dv_loader = BatchLoader(
                dset, args.batch_size,
                ShardedSampler(len(dset), num_replicas, rank, shuffle=False),
                num_workers=3, drop_last=True)
    return text_loader, None, dl3dv_loader, None
