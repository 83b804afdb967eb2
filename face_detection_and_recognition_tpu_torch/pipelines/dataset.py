"""Dataset walking and media decoding for the batch pipelines.

The counterpart of ``pipelines/dataset.py`` in the JAX package, which
reproduces the reference's dataset contract
(``face_extraction/extract_faces_from_dataset.py``): a one-level class tree
``dataset/class_x/{images,videos}``, the caps MAX_N_FRAME_FROM_VID=15 and
MAX_N_FACES_PER_FRAME=3 (``:38-40,421-437``), resume by existence
(``:410-419``). Decode runs on host threads that fill a bounded queue while
the card consumes.

Images are read by the port's decoders (``utils/native.py``: JPEG, PNG,
BMP). Videos are Motion-JPEG AVI files (``utils/video.py``), sampled as the
JAX package samples them: one frame a second of footage, at most
``MAX_N_FRAME_FROM_VID``, and only the frames kept are decoded. A loader
worker that cannot read an item (a video of another codec or container, a
WebP, a corrupt file) logs the error and hands the item on with no frames,
so the job records it as failed and goes on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import itertools
import logging
import os
import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np

from ..utils.native import IMAGE_EXTENSIONS, read_image_bgr
from ..utils.video import VideoReader

MAX_N_FRAME_FROM_VID = 15
MAX_N_FACES_PER_FRAME = 3

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
_VID_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")

logger = logging.getLogger("face_extraction")


@dataclasses.dataclass
class MediaItem:
    class_name: str
    path: str
    kind: str  # "image" | "video"


def walk_class_tree(data_dir: str) -> List[MediaItem]:
    """Enumerate media under one-level class dirs, alphabetical order."""
    items: List[MediaItem] = []
    for cls_path in sorted(glob.glob(os.path.join(data_dir, "*"))):
        if not os.path.isdir(cls_path):
            continue
        cls = os.path.basename(cls_path)
        for p in sorted(glob.glob(os.path.join(cls_path, "*"))):
            ext = os.path.splitext(p)[1].lower()
            if ext in _IMG_EXTS:
                items.append(MediaItem(cls, p, "image"))
            elif ext in _VID_EXTS:
                items.append(MediaItem(cls, p, "video"))
    return items


def iter_media_frames(
    item: MediaItem,
    max_frames: int = MAX_N_FRAME_FROM_VID,
) -> Iterator[Tuple[int, np.ndarray]]:
    """Yield (frame_index, BGR frame). An image yields once (nothing when it
    does not decode); a WebP or another variant the decoders do not read
    raises ``ValueError``. A video yields one frame a second of footage
    (``frame_num % round(fps) == 0``, every 25th where the file gives no
    fps), at most ``max_frames`` (reference ``:421-437``), read by
    ``utils.video.VideoReader.frames(keep=...)``, which decodes only those
    and ends them as it ends every read; a video that is not a Motion-JPEG
    AVI raises ``ValueError``."""
    if item.kind == "image":
        img = read_image_bgr(item.path, formats=IMAGE_EXTENSIONS)
        if img is not None:
            yield 0, img
        return
    reader = VideoReader(item.path)
    fps = reader.fps
    step = max(1, round(fps)) if fps and np.isfinite(fps) else 25
    with contextlib.closing(reader.frames(keep=lambda n: n % step == 0)) \
            as frames:
        for taken, frame in enumerate(itertools.islice(frames, max_frames)):
            yield taken * step, frame


class PrefetchLoader:
    """Host-side decode pipeline: N worker threads decode media into a
    bounded queue while the device consumes."""

    _END = object()

    def __init__(self, items: List[MediaItem], num_workers: int = 4,
                 queue_size: int = 16, max_frames: int = MAX_N_FRAME_FROM_VID):
        self.items = items
        self.num_workers = max(1, num_workers)
        self.max_frames = max_frames
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._item_q: "queue.Queue" = queue.Queue()
        for it in items:
            self._item_q.put(it)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    def _read(self, item: MediaItem) -> List[Tuple[int, np.ndarray]]:
        """The item's frames; none when it cannot be read. The worker must
        live on to put ``_END``, or the consumer would wait forever."""
        try:
            return list(iter_media_frames(item, self.max_frames))
        except Exception:  # a per-item failure, recorded by the job
            logger.exception("cannot read %s", item.path)
            return []

    def _worker(self):
        try:
            while not self._stop.is_set():
                try:
                    item = self._item_q.get_nowait()
                except queue.Empty:
                    break
                frames = self._read(item)
                # timed put so a consumer that stopped iterating (exception,
                # early break) cannot park this thread forever on a full
                # queue
                while not self._stop.is_set():
                    try:
                        self._q.put((item, frames), timeout=0.2)
                        break
                    except queue.Full:
                        continue
        finally:
            self._q.put(self._END)  # close() drains, so this cannot deadlock

    def close(self):
        """Stop workers and reclaim their threads; safe to call twice.
        Runs automatically when iteration ends OR is abandoned."""
        self._stop.set()
        while any(t.is_alive() for t in self._threads):
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        for t in self._threads:
            t.join()
        self._threads = []

    def __iter__(self):
        for _ in range(self.num_workers):
            t = threading.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)
        done = 0
        try:
            while done < self.num_workers:
                got = self._q.get()
                if got is self._END:
                    done += 1
                    continue
                yield got
        finally:
            self.close()


def output_exists(out_dir: str, class_name: str, media_path: str,
                  feature: bool) -> bool:
    """Resume-by-existence check (reference ``:410-419``)."""
    stem = os.path.splitext(os.path.basename(media_path))[0]
    if feature:
        return os.path.exists(os.path.join(out_dir, class_name, stem + ".npy"))
    d = os.path.join(out_dir, class_name, stem)
    return os.path.isdir(d) and bool(os.listdir(d))
