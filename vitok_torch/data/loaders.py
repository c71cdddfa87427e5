"""Data loading: image folders into collated NaFlex patch-dict batches.

Port of the image-folder source of ``vitok_tpu/data/loaders.py``: the same
file order for a seed, rank-strided sharding, ignore-and-continue on corrupt
files, the Python collate path, and a background prefetch thread with a
bounded queue that overlaps host decode and transforms with the device.
Batches are numpy patch dicts; the training loop makes the one host-to-device
copy per step.

Not ported yet (ROADMAP.md Queue 1 item 10): tar shards and ``hf://`` URLs,
named streaming datasets, the threaded decode pool (``decode_workers``) and
the native collate. Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import itertools
import os
import queue
import random
import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
from PIL import Image, ImageOps

from vitok_torch.pp.io import patch_collate_fn
from vitok_torch.pp.registry import build_transform

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".webp", ".bmp", ".ppm")


def to_rgb(img: "Image.Image") -> "Image.Image":
    """EXIF-transpose, alpha-composite over white, convert to RGB."""
    try:
        img = ImageOps.exif_transpose(img)
    except Exception:
        pass
    if img.mode in ("RGBA", "LA", "PA"):
        background = Image.new("RGB", img.size, (255, 255, 255))
        background.paste(img, mask=img.getchannel("A"))
        return background
    if img.mode != "RGB":
        return img.convert("RGB")
    return img


def _iter_image_folder(
    root: str, rank: int, world: int, seed: int, repeat: bool
) -> Iterator[Tuple["Image.Image", int]]:
    files = sorted(
        os.path.join(dp, f)
        for dp, _, fs in os.walk(root)
        for f in fs
        if f.lower().endswith(IMAGE_EXTENSIONS)
    )
    rng = random.Random(seed)
    rng.shuffle(files)
    files = files[rank::world]
    if not files:
        return
    for epoch in itertools.count():
        order = list(files)
        random.Random(seed + epoch).shuffle(order)
        for path in order:
            try:
                yield to_rgb(Image.open(path)), -1
            except Exception:
                continue
        if not repeat:
            return


class PrefetchingLoader:
    """Iterate collated batches with a background producer thread.

    The consumer may abandon iteration at any point (``break``, a partial
    ``iter()``): closing the generator signals the producer, which unblocks
    from the bounded queue and closes its source instead of leaking a
    blocked thread per abandoned iterator.
    """

    def __init__(self, gen_factory: Callable[[], Iterator], prefetch: int = 2):
        self._factory = gen_factory
        self._prefetch = prefetch

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        sentinel = object()
        stop = threading.Event()
        error: List[BaseException] = []

        def put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                src = self._factory()
                for item in src:
                    put(item)
                    if stop.is_set():
                        if hasattr(src, "close"):
                            src.close()
                        return
            except BaseException as e:  # handed to the consumer
                error.append(e)
            finally:
                put(sentinel)  # the consumer blocks on q.get until it sees this

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            # Drain so a producer blocked on put() can observe the stop.
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass


def iter_samples(
    source: str,
    seed: int = 0,
    rank: int = 0,
    world: int = 1,
    repeat: bool = False,
    shuffle_buffer: int = 250,
    min_size: int = 0,
) -> Iterator[Tuple["Image.Image", int]]:
    """Raw ``(PIL image, label)`` stream from a directory of images (label
    -1), rank-strided as in ``create_dataloader``, without the transform and
    collate stage. ``shuffle_buffer`` and ``min_size`` belong to the tar
    source and are unused here."""
    if os.path.isdir(source):
        return _iter_image_folder(source, rank, world, seed, repeat)
    raise NotImplementedError(
        f"data source {source!r}: only a directory of images is ported; tar shards, hf:// URLs "
        "and named streaming datasets are queued in ROADMAP.md (Queue 1 item 10)"
    )


def create_dataloader(
    source: str,
    pp: str,
    batch_size: int = 8,
    seed: int = 0,
    rank: int = 0,
    world: int = 1,
    shuffle_buffer: int = 250,
    num_samples: Optional[int] = None,
    repeat: bool = False,
    min_size: int = 0,
    prefetch: int = 2,
    partial: bool = False,
    return_labels: bool = False,
    decode_workers: int = 0,
):
    """Batch loader over a directory of images.

    Each image goes through the ``pp`` transform (which must end in
    ``patchify``); samples whose transform raises are skipped. Yields
    collated numpy patch-dict batches (plus ``labels`` with
    ``return_labels``). ``partial=False`` drops a ragged final batch.
    """
    if decode_workers:
        raise NotImplementedError(
            "decode_workers > 0 (the threaded decode pool) is not ported: ROADMAP.md Queue 1 item 10"
        )
    transform = build_transform(pp)

    def batch_gen():
        batch: List = []
        labels: List[int] = []
        n_seen = 0
        samples = iter_samples(source, seed=seed, rank=rank, world=world, repeat=repeat,
                               shuffle_buffer=shuffle_buffer, min_size=min_size)
        for img, label in samples:
            if num_samples is not None and n_seen >= num_samples:
                break
            try:
                d = transform(img)
            except Exception:
                continue  # ignore and continue, as for a corrupt file
            batch.append(d)
            labels.append(label)
            n_seen += 1
            if len(batch) == batch_size:
                yield _emit(batch, labels)
                batch, labels = [], []
        if batch and partial:
            yield _emit(batch, labels)

    def _emit(batch, labels):
        out = patch_collate_fn(batch)
        if return_labels:
            out["labels"] = np.asarray(labels, np.int64)
        return out

    return PrefetchingLoader(batch_gen, prefetch=prefetch)


__all__ = [
    "create_dataloader",
    "iter_samples",
    "patch_collate_fn",
    "to_rgb",
    "PrefetchingLoader",
    "IMAGE_EXTENSIONS",
]
