"""Inference entry points: an image or a video through a FaceEngine,
annotated and written.

The counterpart of ``core/inference.py`` in the JAX package (the reference's
``modules/utils/inference.py``). ``inference_img`` decodes one JPEG (the
port's codec, ``utils/native.py``), detects or detects + age/gender, draws
and writes. ``inference_vid`` runs the JAX package's micro-batched,
double-buffered video loop on a Motion-JPEG AVI file and writes the
annotated frames as Motion-JPEG AVI (``utils/video.py``); the JAX package
reads any codec cv2 reads and writes ``mp4v``. The port has no display
window (``display=True`` raises) and no camera capture (a camera index
raises).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from ..models.age_gender import labels_from_probs
from ..utils.draw import draw_bbox_on_image
from ..utils.native import read_image_bgr, write_image_bgr
from ..utils.video import VideoReader, VideoWriter, check_output_path
from .detections import Detections, PostProcessedDetection
from .engine import FaceEngine

NO_WINDOW = ("the port has no display window: pass display=False "
             "(--no-display on the command line) and write the result with "
             "output= (-o)")
NO_CAMERA = ("the port has no camera capture (the JAX package reads a "
             "camera with cv2.VideoCapture): record the camera to a "
             "Motion-JPEG AVI file and read that")

def annotate(img: np.ndarray, post: PostProcessedDetection) -> np.ndarray:
    return draw_bbox_on_image(img, post)


def inference_img(
    engine: FaceEngine,
    img,
    wname: str = "Output",
    waitKey_val: int = 0,
    output: Optional[str] = None,
    display: bool = True,
    age_gender: bool = False,
) -> PostProcessedDetection:
    """Run detection (+ optional age/gender) on one image (a JPEG path or a
    BGR uint8 array, drawn on in place), draw, and write ``output``.
    ``wname`` and ``waitKey_val`` are the JAX signature's window arguments;
    ``display`` must be False."""
    if display:
        raise RuntimeError(NO_WINDOW)
    if isinstance(img, str):
        if not os.path.exists(img):
            raise FileNotFoundError(f"{img} does not exist")
        image = read_image_bgr(img)
        if image is None:  # exists but not a JPEG the route decodes
            raise ValueError(f"cannot decode image: {img}")
    elif isinstance(img, np.ndarray):
        image = img
    else:
        raise ValueError("image cannot be read")

    post = (engine.detect_age_gender(image) if age_gender
            else engine.detect_image(image))
    annotate(image, post)
    if output:
        write_image_bgr(output, image)
    return post


def _default_micro_batch(device: torch.device) -> int:
    """The JAX package's rule: the accelerator's throughput batch (32) on
    the card, a latency batch (4) on the CPU."""
    return 32 if device.type == "cuda" else 4


def is_camera(src) -> bool:
    """A camera index (an int or a numeric string), as ``get_file_type``
    reads one."""
    return isinstance(src, int) or str(src).isnumeric()


def _to_host(tensors):
    """(host tensors, event): the tensors' copies to pinned host memory,
    started without waiting, and an event after them on their device's
    current stream (None on the CPU, where they are host tensors already).
    Waiting on the event waits for this block's work alone: a blocking
    ``.cpu()`` would also wait for the next block, dispatched after it."""
    tensors = [t.float() if t.dtype == torch.bfloat16 else t
               for t in tensors]
    if not tensors[0].is_cuda:
        return tensors, None
    device = tensors[0].device
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    with torch.cuda.device(device):  # the copies on the tensors' stream
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
    return host, done


def inference_vid(
    engine: FaceEngine,
    vid,
    wname: str = "Output",
    output: Optional[str] = None,
    display: bool = True,
    age_gender: bool = False,
    micro_batch: Optional[int] = None,
) -> List[PostProcessedDetection]:
    """The video loop of the JAX package: frame micro-batches, double
    buffered. Returns one result a frame, in order, each frame annotated
    and written to ``output`` (a ``.avi``) at the source's fps (25 where
    it gives none).

    A reader thread decodes the Motion-JPEG frames (on
    ``utils.video.DECODE_WORKERS`` threads, in order; the writer encodes
    on ``ENCODE_WORKERS`` more), groups them in blocks of ``micro_batch``
    (None: 32 on the card, 4 on the CPU), pads a short last block with its
    last frame, stacks it into pinned memory and copies it to the card on
    a side stream, into a queue two blocks deep. The loop dispatches block
    k+1 before it collects block k: the card computes k+1 while the host
    annotates and writes k. A block's results come to the host through
    pinned copies started at its dispatch, waited for by an event of its
    own. Only a block's real frames are returned and written.

    ``age_gender`` with an engine that has age/gender heads and a fixed
    input size runs each block through ``detect_embed_classify_batch``
    (no embed stage) and labels the faces from one host copy of the
    block's probabilities; otherwise (MTCNN) each frame runs
    ``detect_age_gender``, and its blocks are not uploaded. ``wname`` is
    the JAX signature's window argument; ``display`` must be False. A
    camera index raises ``NotImplementedError``; a file that is not a
    Motion-JPEG AVI, or an ``output`` that is not a ``.avi``, raises
    ``ValueError`` before any work. An error of the reader thread is
    raised here."""
    if display:
        raise RuntimeError(NO_WINDOW)
    if is_camera(vid):
        raise NotImplementedError(NO_CAMERA)
    if output:
        check_output_path(output)
    reader = VideoReader(vid)
    if micro_batch is None:
        micro_batch = _default_micro_batch(engine.device)
    src_fps = reader.fps or 25.0
    fused_ag = age_gender and engine.ag_net is not None \
        and not engine.native_resolution
    # the staged per-frame path reads the host frames only: uploading its
    # blocks would waste the copy
    staged = age_gender and not fused_ag
    cuda = engine.device.type == "cuda"
    side = torch.cuda.Stream(engine.device) if cuda and not staged else None
    writer: List[VideoWriter] = []
    results: List[PostProcessedDetection] = []
    blocks: "queue.Queue" = queue.Queue(maxsize=2)  # the double buffer
    stop = threading.Event()
    reader_error: List[BaseException] = []
    end = object()

    def put(item) -> None:
        """A timed put, so that a loop that stopped cannot park the reader
        on a full queue."""
        while not stop.is_set():
            try:
                blocks.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def upload(block: List[np.ndarray]):
        """(frames, the block on the device or None, the copy's event and
        its pinned source, kept alive until the block is consumed)."""
        if staged:
            return block, None, None
        padded = block + [block[-1]] * (micro_batch - len(block))
        if not cuda:
            return block, torch.from_numpy(np.stack(padded)), None
        host = torch.empty((micro_batch,) + block[0].shape, dtype=torch.uint8,
                           pin_memory=True)
        np.stack(padded, out=host.numpy())
        with torch.cuda.device(engine.device), torch.cuda.stream(side):
            frames = host.to(engine.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(side)
        return block, frames, (copied, host)

    def read() -> None:
        try:
            block: List[np.ndarray] = []
            for frame in reader.frames():
                if stop.is_set():
                    break
                block.append(frame)
                if len(block) == micro_batch:
                    put(upload(block))
                    block = []
            if block and not stop.is_set():
                put(upload(block))
        except BaseException as e:  # raised by the loop, not swallowed
            reader_error.append(e)
        finally:
            put(end)

    def dispatch(item):
        """One block's device work, queued: (frames, host copies, event)."""
        block, frames, upload_sync = item
        if upload_sync is not None:
            stream = torch.cuda.current_stream(engine.device)
            stream.wait_event(upload_sync[0])
            frames.record_stream(stream)  # allocated on the side stream
        if fused_ag:
            res = engine.detect_embed_classify_batch(frames, want_embed=False)
            det = res.det
            extra = [res.age_probs, res.gender_probs]
        else:
            det = engine.detect_batch(frames)
            extra = []
        return (block,) + _to_host([det.boxes, det.scores, det.lmarks,
                                    det.areas, det.valid] + extra)

    def emit_frame(frame: np.ndarray, post: PostProcessedDetection) -> None:
        annotate(frame, post)
        results.append(post)
        if output:
            if not writer:  # sized by the first frame
                writer.append(VideoWriter(output, src_fps,
                                          (frame.shape[1], frame.shape[0])))
            writer[0].write(frame)

    def emit(handle) -> None:
        block, host, done = handle
        if done is not None:
            done.synchronize()
        posts = Detections(*host[:5]).to_numpy()[:len(block)]
        if fused_ag:
            valid, ages, genders = (t.numpy() for t in (host[4], *host[5:]))
            for i, p in enumerate(posts):
                p.bbox_labels = list(labels_from_probs(ages[i][valid[i]],
                                                       genders[i][valid[i]]))
        for frame, post in zip(block, posts):
            emit_frame(frame, post)

    thread = threading.Thread(target=read, daemon=True, name="video-reader")
    thread.start()
    try:
        with torch.profiler.record_function("inference_vid"):
            if staged:
                while (item := blocks.get()) is not end:
                    for frame in item[0]:
                        emit_frame(frame, engine.detect_age_gender(frame))
            else:
                pending = None
                while (item := blocks.get()) is not end:
                    handle = dispatch(item)   # queued: the card starts now
                    if pending is not None:
                        emit(pending)         # host work beside the card's
                    pending = handle
                if pending is not None:
                    emit(pending)
    finally:
        stop.set()
        while thread.is_alive():  # unblock a reader on a full queue
            try:
                blocks.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()
        if writer:
            writer[0].release()
    if reader_error:
        raise reader_error[0]
    return results


def inference_webcam(
    engine: FaceEngine, cam_index: int, wname: str = "Output",
    age_gender: bool = False,
) -> None:
    """The video loop at micro-batch 1, for the lowest latency. A camera
    index raises ``NotImplementedError`` (the port has no camera capture);
    another source (a Motion-JPEG AVI file) runs ``inference_vid`` with no
    window, as the JAX package does with one."""
    if is_camera(cam_index):
        raise NotImplementedError(NO_CAMERA)
    inference_vid(engine, cam_index, wname=wname, display=False,
                  age_gender=age_gender, micro_batch=1)
