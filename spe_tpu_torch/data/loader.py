"""Batched data loader producing fixed-shape device-ready arrays.

Replaces the reference's torch DataLoader + NestedTensor collate
(util/misc.py:276-336): images padded to the max shape in the batch with a
True-on-padding mask (the published fixed-size recipe makes all images the
same SxS so the mask is empty), plus the weak labels and eval metadata.

Background prefetching uses a thread pool (decode/augment on host while the
device computes). The port's copy of spe_tpu/data/loader.py keeps the PIL
decode path only: the JAX package's C++ decoder (`use_native`) is not
ported.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def collate(samples: Sequence, num_classes: int, fixed_size: Optional[int] = None,
            size_divisor: int = 16, max_gt: int = 0,
            bucket_quantum: int = 0) -> Dict[str, np.ndarray]:
    """samples: list of (image (H,W,3) float32, target dict).

    max_gt > 0 additionally emits padded GT arrays (gt_boxes normalized
    cxcywh in the resized image frame, gt_labels det-class columns = label+1,
    gt_mask) for eval-time criterion losses (reference engine.py:644-660).

    bucket_quantum > 0 rounds the padded (H, W) UP to multiples of the
    quantum instead of the per-batch max: under jit every distinct batch
    shape is a fresh compilation, so the multi-scale recipe would otherwise
    recompile per unique image size (SURVEY §5.7 shape-bucketed padding).
    The number of compiled shapes is bounded by (max_size/quantum)^2 and in
    practice by the transform's scale ladder; per-bucket pos-embed
    interpolation constants are baked per compiled shape at trace time."""
    imgs = [s[0] for s in samples]
    targets = [s[1] for s in samples]
    if fixed_size is not None:
        H = W = fixed_size
    else:
        H = max(i.shape[0] for i in imgs)
        W = max(i.shape[1] for i in imgs)
        q = bucket_quantum if bucket_quantum > 0 else size_divisor
        H = -(-H // q) * q
        W = -(-W // q) * q
    B = len(imgs)
    images = np.zeros((B, H, W, 3), np.float32)
    pad_mask = np.ones((B, H, W), bool)
    for b, im in enumerate(imgs):
        h, w = im.shape[:2]
        images[b, :h, :w] = im
        pad_mask[b, :h, :w] = False

    batch = {
        "images": images,
        "pad_mask": pad_mask,
        "img_label": np.stack([t["img_label"] for t in targets]).astype(np.float32),
        "image_id": np.array([t["image_id"] for t in targets], np.int64),
        "orig_size": np.stack([t["orig_size"] for t in targets]).astype(np.int64),
        "size": np.stack([t.get("size", t["orig_size"]) for t in targets]).astype(np.int64),
    }
    if max_gt > 0:
        gt_boxes = np.zeros((B, max_gt, 4), np.float32)
        gt_boxes[..., 2:] = 1e-3  # degenerate-free padding
        gt_labels = np.zeros((B, max_gt), np.int32)
        gt_mask = np.zeros((B, max_gt), bool)
        for b, t in enumerate(targets):
            bx = np.asarray(t.get("boxes", np.zeros((0, 4))), np.float32)
            n = min(len(bx), max_gt)
            if n:
                h, w = batch["size"][b]
                cxcywh = np.stack([(bx[:n, 0] + bx[:n, 2]) / 2 / w,
                                   (bx[:n, 1] + bx[:n, 3]) / 2 / h,
                                   (bx[:n, 2] - bx[:n, 0]) / w,
                                   (bx[:n, 3] - bx[:n, 1]) / h], axis=-1)
                gt_boxes[b, :n] = cxcywh
                gt_labels[b, :n] = np.asarray(t["labels"][:n], np.int32)
                gt_mask[b, :n] = True
        batch.update(gt_boxes=gt_boxes, gt_labels=gt_labels, gt_mask=gt_mask)
        if any("masks" in t for t in targets):
            # instance masks padded into the image canvas (masks training,
            # reference loss_masks targets)
            gt_masks = np.zeros((B, max_gt, H, W), np.uint8)
            for b, t in enumerate(targets):
                m = np.asarray(t.get("masks", np.zeros((0, 1, 1), np.uint8)))
                n = min(len(m), max_gt)
                if n:
                    h, w = m.shape[1:3]
                    gt_masks[b, :n, :h, :w] = m[:n]
            batch["gt_masks"] = gt_masks
    return batch


class DataLoader:
    """Epoch-based loader with shuffling, per-process sharding (the
    DistributedSampler replacement, main.py:196-197) and thread prefetch."""

    def __init__(self, dataset, batch_size: int, num_classes: int,
                 fixed_size: Optional[int] = None, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, num_threads: int = 2,
                 use_native: bool = False, train: bool = True,
                 max_gt: int = 0, bucket_quantum: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.fixed_size = fixed_size
        self.max_gt = max_gt
        self.bucket_quantum = bucket_quantum
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.train = train
        if use_native:
            raise NotImplementedError(
                "the native C++ decode path is not ported to spe_tpu_torch: "
                "use the PIL path (use_native=False)")

    def _indices(self, epoch: int) -> List[int]:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)  # set_epoch equivalent
            rng.shuffle(idx)
        if self.drop_last and self.process_count > 1:
            # every process the same number of samples, hence of steps: a
            # step all-reduces (DistributedSampler's drop_last=True)
            idx = idx[:len(idx) // self.process_count * self.process_count]
        return list(idx[self.process_index::self.process_count])

    def steps_per_epoch(self) -> int:
        n = len(self._indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _bucket_of(self, shape) -> tuple:
        q = self.bucket_quantum
        return (-(-shape[0] // q) * q, -(-shape[1] // q) * q)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices(epoch)
        nb = self.steps_per_epoch()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def make_batch(bidx):
            samples = [self.ds[i] for i in bidx]
            return collate(samples, self.num_classes, self.fixed_size,
                           max_gt=self.max_gt,
                           bucket_quantum=self.bucket_quantum)

        # size-grouped batching for the multi-scale recipe: assemble batches
        # from SAME-BUCKET samples so a batch pads to its own bucket instead
        # of the max over a random mix (which lands in the largest bucket
        # almost every batch). The multi-scale transform samples the scale
        # inside ds[i], so grouping happens post-decode: per-bucket pools
        # fill as the shuffled stream is consumed and a batch is emitted
        # whenever a pool reaches batch_size (tf.data bucket_by_* style).
        # Epoch end flushes leftovers as full MIXED batches (padded to the
        # max bucket among them — still a bucketed shape) and drops the
        # final < batch_size remainder exactly like drop_last; emitted step
        # count == steps_per_epoch().
        group = (self.bucket_quantum > 0 and self.fixed_size is None
                 and self.train and self.drop_last)

        def worker_grouped():
            try:
                pools: Dict[tuple, list] = {}
                emitted = 0
                for i in idx:
                    s = self.ds[i]
                    key = self._bucket_of(s[0].shape)
                    pool = pools.setdefault(key, [])
                    pool.append(s)
                    if len(pool) == self.batch_size:
                        q.put(collate(pools.pop(key), self.num_classes, None,
                                      max_gt=self.max_gt,
                                      bucket_quantum=self.bucket_quantum))
                        emitted += 1
                rest = [s for pool in pools.values() for s in pool]
                while emitted < nb and len(rest) >= self.batch_size:
                    chunk, rest = rest[:self.batch_size], rest[self.batch_size:]
                    q.put(collate(chunk, self.num_classes, None,
                                  max_gt=self.max_gt,
                                  bucket_quantum=self.bucket_quantum))
                    emitted += 1
            finally:
                q.put(stop)

        def worker():
            try:
                for bidx in batches:
                    q.put(make_batch(bidx))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker_grouped if group else worker,
                             daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
