"""Similar-face filtering and gallery search on the card.

The counterpart of ``pipelines/similarity.py`` in the JAX package, a rebuild
of the reference's ``similar_face_filtering/filter_faces_using_reference.py``:

* per class, a mean reference embedding and a threshold, the largest L2
  distance of the (at most 32) reference images from that mean (``:71-100``);
* every unfiltered image is kept if ||f - mean|| <= threshold
  (``:183-197``), all classes at once through one [N, D] x [D, M] product;
* ``topk_similar``, the cosine top-k of embeddings against a gallery, on
  the default path a matrix product and a top-k, or through the B4 kernel.

Arrays cross the API as numpy, as in the JAX package; the work runs on the
card unless the caller passes ``device="cpu"``. File copying stays on the
host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import shutil
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.cuda_kernels import topk_gallery
from ..ops.platform import resolve_device

MAX_N_REF_IMGS = 32  # reference cap (:82)

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass
class ClassReference:
    name: str
    mean_vec: np.ndarray  # [D]
    threshold: float


def ref_mean_and_threshold(ref_embeddings: np.ndarray
                           ) -> Tuple[np.ndarray, float]:
    """Mean vector + max-distance threshold from reference embeddings
    (``get_ref_mean_vec_and_thres_from_imgs``, ``:71-100``)."""
    ref = np.asarray(ref_embeddings[:MAX_N_REF_IMGS], np.float32)
    mean = ref.mean(axis=0)
    dists = np.linalg.norm(ref - mean, axis=1)
    return mean, float(dists.max())


@contextlib.contextmanager
def _f32_matmul():
    """Full-f32 matrix products, as the JAX package's ``highest``
    precision: no TF32 on the card for the duration."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def distance_matrix(embeddings: torch.Tensor, means: torch.Tensor
                    ) -> torch.Tensor:
    """[N, D] x [M, D] -> [N, M] L2 distances through one matrix product:
    ||a-b||^2 = ||a||^2 + ||b||^2 - 2ab."""
    a2 = (embeddings ** 2).sum(1, keepdim=True)
    b2 = (means ** 2).sum(1)
    with _f32_matmul():
        d2 = a2 + b2 - 2.0 * embeddings @ means.T
    return d2.clamp(min=0.0).sqrt()


def filter_embeddings(embeddings: np.ndarray,
                      references: Sequence[ClassReference],
                      class_ids: Optional[np.ndarray] = None,
                      device: Device = None) -> np.ndarray:
    """Keep mask: embedding i is 'clean' for its class (or for any class when
    class_ids is None) if within that class's threshold."""
    dev = resolve_device(device)
    means = np.stack([r.mean_vec for r in references])
    thres = torch.tensor([r.threshold for r in references],
                         dtype=torch.float32, device=dev)
    with torch.inference_mode():
        d = distance_matrix(
            torch.as_tensor(np.asarray(embeddings, np.float32), device=dev),
            torch.as_tensor(np.asarray(means, np.float32), device=dev))
        within = (d <= thres[None, :]).cpu().numpy()
    if class_ids is None:
        return within.any(axis=1)
    return within[np.arange(len(embeddings)), class_ids]


def normalize_rows(a: np.ndarray) -> np.ndarray:
    """Rows scaled to unit L2 norm on the host, norms clipped at 1e-12: the
    JAX package's normalisation, value for value."""
    return a / np.linalg.norm(a, axis=1, keepdims=True).clip(1e-12)


def _topk_stable(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, equal scores in
    index order (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def topk_similar(embeddings: np.ndarray, gallery: np.ndarray, k: int = 5,
                 use_pallas: bool = False, mesh=None, device: Device = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine top-k against a gallery: (scores [N, k] descending, indices
    [N, k]), equal scores in index order.

    Rows are L2-normalised on the host as the JAX package does it (norms
    clipped at 1e-12), then searched on ``device`` (the card unless
    ``"cpu"``). ``use_pallas`` keeps the JAX package's name: True streams
    the gallery through the B4 kernel (``ops.cuda_kernels.topk_gallery``,
    k <= 16), which never forms the [N, M] scores, the path for very large
    galleries; the default is one f32 matrix product and a stable top-k.

    ``mesh`` (the gallery sharded over several cards) is not ported yet and
    raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError("topk_similar: the sharded search (mesh=) "
                                  "is not ported yet")
    dev = resolve_device(device)
    e = normalize_rows(np.asarray(embeddings, np.float32))
    g = normalize_rows(np.asarray(gallery, np.float32))
    with torch.inference_mode():
        et = torch.as_tensor(e, device=dev)
        gt = torch.as_tensor(g, device=dev)
        if use_pallas:
            scores, idx = topk_gallery(et, gt, k)
        else:
            with _f32_matmul():
                scores, idx = _topk_stable(et @ gt.T, k)
        return scores.cpu().numpy(), idx.to(torch.int32).cpu().numpy()


class SimilarFaceFilter:
    """Directory-level job matching the reference layout:

        data_dir/class_x/*.jpg        (unfiltered images)
        ref_dir/class_x/*.jpg         (reference images, <=32 used)
        target_dir/class_x/{clean,unclean}/

    ``embed_fn(paths) -> [N, D]`` abstracts the embedder (any engine);
    ``device`` is where the distances are computed."""

    def __init__(self, embed_fn: Callable[[List[str]], np.ndarray],
                 batch_size: int = 32, device: Device = None):
        self.embed_fn = embed_fn
        self.batch_size = batch_size
        self.device = resolve_device(device)

    def build_references(self, ref_dir: str) -> Dict[str, ClassReference]:
        refs = {}
        for cls_path in sorted(glob.glob(os.path.join(ref_dir, "*"))):
            if not os.path.isdir(cls_path):
                continue
            imgs = sorted(
                p for p in glob.glob(os.path.join(cls_path, "*"))
                if os.path.isfile(p)
            )[:MAX_N_REF_IMGS]
            if not imgs:
                continue
            emb = self.embed_fn(imgs)
            mean, thr = ref_mean_and_threshold(emb)
            refs[os.path.basename(cls_path)] = ClassReference(
                os.path.basename(cls_path), mean, thr
            )
        return refs

    def filter_class_dir(self, data_dir: str, target_dir: str,
                         ref: ClassReference, cls: str) -> Tuple[int, int]:
        clean_dir = os.path.join(target_dir, cls, "clean")
        unclean_dir = os.path.join(target_dir, cls, "unclean")
        os.makedirs(clean_dir, exist_ok=True)
        os.makedirs(unclean_dir, exist_ok=True)
        paths = sorted(
            p for p in glob.glob(os.path.join(data_dir, cls, "*"))
            if os.path.isfile(p)
        )
        n_clean = 0
        for i in range(0, len(paths), self.batch_size):
            chunk = paths[i:i + self.batch_size]
            emb = self.embed_fn(chunk)
            keep = filter_embeddings(
                emb, [ref], class_ids=np.zeros(len(chunk), int),
                device=self.device)
            for p, k in zip(chunk, keep):
                shutil.copy(p, clean_dir if k else unclean_dir)
                n_clean += bool(k)
        return n_clean, len(paths)

    def run(self, data_dir: str, ref_dir: str, target_dir: str
            ) -> Dict[str, Tuple[int, int]]:
        refs = self.build_references(ref_dir)
        out = {}
        for cls, ref in refs.items():
            if os.path.isdir(os.path.join(data_dir, cls)):
                out[cls] = self.filter_class_dir(data_dir, target_dir, ref,
                                                 cls)
        return out
