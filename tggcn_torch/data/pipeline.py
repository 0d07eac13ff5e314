"""Length-bucketed batching (counterpart of ``tggcn/data/pipeline.py``).

A loader pads every batch to the longest clip of its split. Bucketing
groups clips by downsampled length into a few contiguous buckets, pads
each bucket to its own longest, and interleaves the buckets' batches, so
less of each batch is padding.

With the reference's GeoGCN reshape (``geometry_flatten='reference'``, a
raw-memory reshape whose layout depends on the padded length T), padding
per bucket changes the geometry inputs against global padding; use
``geometry_flatten='per_frame'`` where invariance to the padded length
matters.
"""

from typing import Callable, List

import numpy as np

from tggcn_torch.data.loading import ArrayDataLoader


def bucket_by_length(data: list, num_buckets: int, length_fn: Callable) -> List[list]:
    """Split raw per-video records into contiguous length-sorted buckets."""
    if num_buckets <= 1 or len(data) <= num_buckets:
        return [data]
    order = sorted(range(len(data)), key=lambda i: length_fn(data[i]))
    buckets = []
    per_bucket = (len(data) + num_buckets - 1) // num_buckets
    for start in range(0, len(data), per_bucket):
        buckets.append([data[i] for i in order[start:start + per_bucket]])
    return buckets


class BucketedDataLoader:
    """Interleaves batches from per-bucket ArrayDataLoaders.

    Exposes the same interface as ArrayDataLoader (num_examples, batch_size,
    dataset, __len__, __iter__); `dataset` indexes into the first bucket,
    which is sufficient for feature-size probing.
    """

    def __init__(self, bucket_tensor_lists: List[list], batch_size: int, shuffle: bool,
                 seed: int = 0):
        self.loaders = [ArrayDataLoader(tensors, batch_size=batch_size, shuffle=shuffle,
                                        seed=seed + i)
                        for i, tensors in enumerate(bucket_tensor_lists)]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self.num_examples = sum(loader.num_examples for loader in self.loaders)

    @property
    def dataset(self):
        return self.loaders[0].dataset

    def set_epoch(self, epoch: int) -> None:
        """Pin shuffle + interleave order to (seed, epoch) for resume parity."""
        self._epoch = int(epoch)
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def __len__(self):
        return sum(len(loader) for loader in self.loaders)

    def __iter__(self):
        iterators = []
        for i, loader in enumerate(self.loaders):
            iterators.extend([(i, batch) for batch in loader])
        if self.shuffle:
            np.random.default_rng((self.seed, self._epoch, 17)).shuffle(iterators)
            self._epoch += 1
        for _i, batch in iterators:
            yield batch


def make_bucketed_loader(raw_data: list, assemble_fn: Callable, num_buckets: int,
                         batch_size: int, shuffle: bool, length_fn: Callable,
                         seed: int = 0) -> BucketedDataLoader:
    """Assemble each length bucket independently and interleave their batches.

    assemble_fn(bucket_raw) must return the flat tensor list (xs + ys) for
    that bucket, padded to the bucket's own max length.
    """
    buckets = bucket_by_length(raw_data, num_buckets, length_fn)
    return BucketedDataLoader([assemble_fn(bucket) for bucket in buckets],
                              batch_size=batch_size, shuffle=shuffle, seed=seed)
