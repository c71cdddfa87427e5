"""Static-shape serving: NaFlex token-count bucketing.

Port of ``vitok_tpu/serving.py``. ``TokenBucketer`` snaps every image to
the smallest bucket whose token budget holds its patch grid (resizing down
only when even the largest bucket overflows) and groups a request stream
into per-bucket batches; ``ServingPipeline`` runs each batch through the
model at one of ``len(buckets)`` static shapes and hands every
reconstruction back at its stream position. The largest default bucket
(4096 tokens, a 1024p image) runs on the flash attention kernel, the
smaller ones on the fused kernel.

``stream()`` is synchronous per batch, as the JAX package's is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vitok_torch.pp.io import patch_collate_fn, postprocess
from vitok_torch.pp.ops import (
    _resize_chw_bicubic,
    fit_to_token_budget,
    normalize,
    patchify_array,
    to_tensor,
)

DEFAULT_BUCKETS = (64, 256, 1024, 4096)


def bucket_for_tokens(n_tokens: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n_tokens, else the largest bucket."""
    for b in sorted(buckets):
        if n_tokens <= b:
            return b
    return max(buckets)


@dataclasses.dataclass
class TokenBucketer:
    """Assigns images to static token buckets, resizing only on overflow."""

    patch: int = 16
    buckets: Sequence[int] = DEFAULT_BUCKETS
    norm_mode: str = "minus_one_to_one"

    def prepare(self, img) -> Tuple[int, dict]:
        """PIL image -> (bucket, numpy patch dict padded to that bucket)."""
        arr = normalize(self.norm_mode)(to_tensor()(img))
        _, h, w = arr.shape
        n = math.ceil(h / self.patch) * math.ceil(w / self.patch)
        bucket = bucket_for_tokens(n, self.buckets)
        if n > bucket:
            th, tw = fit_to_token_budget(h, w, self.patch, bucket)
            arr = _resize_chw_bicubic(arr, th, tw)
        return bucket, patchify_array(arr, self.patch, bucket)

    def batch_stream(
        self, images: Iterable, batch_size: int = 8, flush: bool = True,
        with_indices: bool = False,
    ):
        """Group an image stream into per-bucket collated batches.

        Yields ``(bucket, batch_dict)``, or ``(bucket, batch_dict, indices)``
        with ``with_indices``, where ``indices`` are the positions of the
        batch rows in the input stream (batches come bucket-grouped, not in
        stream order). Each batch has one static (batch_size or smaller,
        bucket) shape.
        """
        pending: Dict[int, List[dict]] = {}
        pending_idx: Dict[int, List[int]] = {}
        for i, img in enumerate(images):
            bucket, d = self.prepare(img)
            pending.setdefault(bucket, []).append(d)
            pending_idx.setdefault(bucket, []).append(i)
            if len(pending[bucket]) == batch_size:
                batch = patch_collate_fn(pending.pop(bucket))
                idx = pending_idx.pop(bucket)
                yield (bucket, batch, idx) if with_indices else (bucket, batch)
        if flush:
            for bucket, ds in sorted(pending.items()):
                batch = patch_collate_fn(ds)
                idx = pending_idx[bucket]
                yield (bucket, batch, idx) if with_indices else (bucket, batch)


class ServingPipeline:
    """Bucketed encode -> decode serving over a fixed set of shapes.

    ``model`` is a ``vitok_torch`` ``AE``; batches go to its device.
    Reconstructions are host tensors ``[C, H, W]`` at each image's
    original size, in ``[-1, 1]``.
    """

    def __init__(
        self,
        model,
        patch: int = 16,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        batch_size: int = 8,
        pad_partial: bool = True,
    ):
        self.model = model
        self.bucketer = TokenBucketer(patch=patch, buckets=buckets)
        self.batch_size = batch_size
        self.pad_partial = pad_partial

    def _pad_batch(self, d: dict) -> Tuple[dict, int]:
        """Pad a ragged final batch up to batch_size (masked rows)."""
        b = d["patches"].shape[0]
        if not self.pad_partial or b == self.batch_size:
            return d, b
        pad = self.batch_size - b
        out = {}
        for k, v in d.items():
            v = np.asarray(v)
            out[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
        return out, b

    def _run_batch(self, ds: List[dict], indices: List[int]):
        """Execute one collated bucket batch; returns [(index, recon)]."""
        padded, n_real = self._pad_batch(patch_collate_fn(ds))
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.model.device) for k, v in padded.items()}
        out = self.model(batch)
        crops = postprocess(
            dict(out), output_format="minus_one_to_one", do_unpack=True,
            patch=self.bucketer.patch,
        )
        return list(zip(indices, crops[:n_real]))

    def stream(
        self,
        images: Iterable,
        ordered: bool = True,
        max_buffered: Optional[int] = None,
    ):
        """Generator over ``(stream_index, reconstruction)`` in bounded memory.

        ``ordered=True`` yields strictly in input-stream order while holding
        at most ``max_buffered`` completed outputs in steady state (default
        ``4 * batch_size``; transiently up to two batches more while a flush
        resolves): when the reorder buffer fills because the head-of-line
        image sits in a bucket whose batch has not filled, that partial
        batch is flushed (padded to the static shape) so the stream always
        makes progress. ``ordered=False`` yields in completion (bucket-batch)
        order with O(one batch) output memory. Either way, pending inputs
        are bounded by ``len(buckets) * batch_size`` patch dicts.

        ``self.stats['max_buffered']`` and ``['forced_flushes']`` record the
        observed high-water mark and the number of head-of-line flushes.
        """
        if max_buffered is None:
            max_buffered = 4 * self.batch_size
        self.stats = {"max_buffered": 0, "forced_flushes": 0}
        pending: Dict[int, List[dict]] = {}
        pending_idx: Dict[int, List[int]] = {}
        completed: Dict[int, torch.Tensor] = {}
        next_emit = 0

        def flush_bucket(bucket):
            outs = self._run_batch(pending.pop(bucket), pending_idx.pop(bucket))
            if ordered:
                completed.update(outs)
                self.stats["max_buffered"] = max(self.stats["max_buffered"], len(completed))
            return outs

        def drain_ready():
            nonlocal next_emit
            while next_emit in completed:
                yield next_emit, completed.pop(next_emit)
                next_emit += 1

        for i, img in enumerate(images):
            bucket, d = self.bucketer.prepare(img)
            pending.setdefault(bucket, []).append(d)
            pending_idx.setdefault(bucket, []).append(i)
            if len(pending[bucket]) == self.batch_size:
                outs = flush_bucket(bucket)
                if ordered:
                    yield from drain_ready()
                else:
                    yield from outs
            # Head-of-line blocking: the next image to emit is stuck in a
            # partial batch while completed outputs pile up behind it, so
            # flush its bucket to cap the reorder buffer.
            while ordered and len(completed) > max_buffered:
                hol = min(
                    (b for b, idxs in pending_idx.items() if idxs),
                    key=lambda b: min(pending_idx[b]),
                )
                self.stats["forced_flushes"] += 1
                flush_bucket(hol)
                yield from drain_ready()

        for bucket in sorted(pending):
            outs = flush_bucket(bucket)
            if not ordered:
                yield from outs
        if ordered:
            yield from drain_ready()

    def run(self, images: Iterable) -> List[torch.Tensor]:
        """Encode + decode a stream; returns the reconstructions in input
        order. Holds every output: use :meth:`stream` for long streams."""
        return [img for _, img in self.stream(images, ordered=True, max_buffered=1 << 30)]


__all__ = ["TokenBucketer", "ServingPipeline", "bucket_for_tokens", "DEFAULT_BUCKETS"]
