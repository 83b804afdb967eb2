"""Model export: programs saved with ``torch.export`` and reloaded without
the Python model code.

The counterpart of ``utils/export.py`` in the JAX package, which serialised
a jitted function as StableHLO that any PJRT runtime could reload. Here a
function of tensors is traced by ``torch.export`` at the examples' static
shapes and written with ``torch.export.save``; ``load_exported`` reads it
back and runs it. The detector, the embedder and the whole fused ensemble
(uint8 frames in; boxes, scores, valid, crops, embeddings and age/gender
out) export as one program each.

The hand-written kernels stay in the program: each is an operator of the
``fdr`` namespace (``ops.cuda_kernels``), its kernel on the card and its
plain version on the CPU, so a reloaded program launches the same kernels
as the engine. A process that reloads a program imports that module and
nothing else of the package: no model code and no engine.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops import cuda_kernels  # noqa: F401  (registers the fdr operators)
from ..ops.platform import full_f32, resolve_device

_DEVICE_FILE = "fdr_device"  # the extra file naming the program's device


class _Program(torch.nn.Module):
    """``fn`` as the module ``torch.export`` traces, the nets it runs
    registered under it so that their weights become the program's
    parameters and buffers."""

    def __init__(self, fn: Callable, nets: Sequence[torch.nn.Module] = ()):
        super().__init__()
        self.fn = fn
        self.nets = torch.nn.ModuleList([n for n in nets if n is not None])

    def forward(self, *args):
        out = self.fn(*args)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _as_tensor(a: Any, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _export(fn: Callable, example_args: Sequence[Any], path: str,
            device: torch.device,
            nets: Sequence[torch.nn.Module] = ()) -> None:
    from ..models.layers import export_packed

    args = tuple(_as_tensor(a, device) for a in example_args)
    module = _Program(fn, nets)
    if device.type == "cuda":
        # one call first makes the constants the program reads on the card
        # (anchors, priors, resample matrices: ops.platform.on_device), so
        # that it holds them there and copies none from the host a call
        with torch.inference_mode(), full_f32(device):
            module(*args)
    # outside inference mode, whose tensors export refuses; the shapes are
    # static, as the JAX export's are
    with torch.inference_mode(False), torch.no_grad(), export_packed(module):
        program = torch.export.export(module, args, strict=False)
    program.example_inputs = None  # the file holds no copy of the inputs
    torch.export.save(program, path, extra_files={_DEVICE_FILE: str(device)})


def export_jitted(fn: Callable, example_args: Sequence[Any], path: str,
                  device: Optional[Union[str, torch.device]] = None) -> None:
    """Export ``fn(*example_args)`` to ``path``: traced by
    ``torch.export`` (non-strict) at the examples' static shapes and
    dtypes, saved with ``torch.export.save``. Numpy examples go to
    ``device`` (None: the card), tensors to it too. ``fn`` returns a
    tensor or a tuple of them; the kernels it reaches are the ``fdr``
    operators."""
    _export(fn, example_args, path, resolve_device(device))


class LoadedProgram:
    """A program reloaded by ``load_exported``: ``call(*args)`` takes numpy
    arrays or tensors, moves them to the program's device and returns the
    outputs as a tuple. It runs in inference mode with cuDNN's TF32 off, as
    the engine runs its nets (``ops.platform.full_f32``)."""

    def __init__(self, program: torch.export.ExportedProgram,
                 device: torch.device):
        self.program = program
        self.device = device
        self._module = program.module()

    def call(self, *args: Any) -> Tuple[torch.Tensor, ...]:
        args = tuple(_as_tensor(a, self.device) for a in args)
        with torch.inference_mode(), full_f32(self.device):
            return tuple(self._module(*args))


def load_exported(path: str) -> LoadedProgram:
    """Reload a program that ``export_*`` saved; returns an object whose
    ``.call(*args)`` runs it. Only the ``fdr`` operators' module is
    needed: no model code. Each weight and constant comes back in a
    storage of its own on the program's device, so the kernels' 16-byte
    alignment holds (a wrapper refuses an unaligned operand)."""
    extra = {_DEVICE_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    return LoadedProgram(program, torch.device(extra[_DEVICE_FILE]))


def export_detector(engine, path: str, batch: int = 1) -> None:
    """Export an engine's raw detect program (preprocessed input [batch, h,
    w, 3] at the detector's input size, in the engine's dtype as
    ``_preprocess`` gives it -> normalized dets + valid) for serving
    runtimes. A native-resolution cascade (MTCNN) raises ``ValueError``:
    it exports per resolution, through ``export_jitted`` with a concrete
    shape."""
    w, h = engine.spec.input_size
    if (w, h) == (-1, -1):
        raise ValueError("native-resolution cascades export per-resolution; "
                         "use export_jitted with a concrete shape")
    example = torch.zeros((batch, h, w, 3), dtype=engine.cfg.dtype)
    _export(engine._detect, [example], path, engine.device, [engine.net])


def export_embedder(engine, path: str, batch: int = 1) -> None:
    """Export the engine's embedder: [batch, eh, ew, 3] BGR crops at its
    input size -> [batch, D] embeddings. An engine with no embedder raises
    ``ValueError``."""
    if engine.embed_net is None:
        raise ValueError("engine has no embedder")
    ew, eh = engine.embed_spec.input_size
    example = np.zeros((batch, eh, ew, 3), np.float32)
    _export(engine._embed, [example], path, engine.device,
            [engine.embed_net])


def export_ensemble(engine, path: str, batch: int = 1,
                    image_hw=(576, 1024), det_thres: float = None,
                    bbox_area_thres: float = None) -> None:
    """Export the whole fused detect -> crop -> embed -> age/gender program
    as one file: [batch, h, w, 3] BGR uint8 frames in, ``(boxes, scores,
    valid, crops[, embeddings][, age_probs, gender_probs])`` out, the
    thresholds (the config's unless given) fixed in the program. The nets
    run on every slot, masked (the eager call skips the slots past the
    last live column, a host read a program cannot hold); invalid slots
    are zero either way."""
    h, w = image_hw
    do_embed, do_ag = engine.embed_net is not None, engine.ag_net is not None
    run = engine._ensemble_fn((h, w, 3), engine._default_crop_size(), None,
                              do_embed, do_ag, skip_slots=False)
    dt = float(engine.cfg.det_thres if det_thres is None else det_thres)
    at = float(engine.cfg.bbox_area_thres if bbox_area_thres is None
               else bbox_area_thres)

    def fn(imgs):
        post, crops, emb, age, gender = run(imgs, dt, at)
        outs = (post.boxes, post.scores, post.valid, crops)
        if emb is not None:
            outs += (emb,)
        if age is not None:
            outs += (age, gender)
        return outs

    example = np.zeros((batch, h, w, 3), np.uint8)
    _export(fn, [example], path, engine.device,
            [engine.net, engine.embed_net, engine.ag_net])
