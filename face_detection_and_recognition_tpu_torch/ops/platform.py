"""Device choice for the port's entry points: the CUDA card unless the caller
asks for the CPU. The counterpart of ``ops/platform.py`` in the JAX package,
which asked whether JAX's default backend was a TPU."""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent:
    an entry point never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def on_device(cache: Dict[Any, Any], key: Any, make: Callable[[], Any],
              maxsize: Optional[int] = None) -> Any:
    """``make()`` (constants on a device), made once a ``key`` (the device,
    or the device and a geometry) and kept in ``cache``; with ``maxsize``
    (``cache`` an ``OrderedDict``), the ``maxsize`` keys used last. While a
    program is exported, a constant made before is the program's own, held
    on its device; one made then is fake and is kept nowhere
    (``utils.export`` runs a program once before it exports it, so that
    none is made then on the card)."""
    if key in cache:
        if maxsize is not None:
            cache.move_to_end(key)
        return cache[key]
    made = make()
    if not torch.compiler.is_exporting():
        cache[key] = made
        if maxsize is not None and len(cache) > maxsize:
            cache.popitem(last=False)
    return made


def full_f32(device: torch.device):
    """cuDNN runs f32 convolutions in TF32 by default; the reference is f32.
    Turn TF32 off for the forward only, leaving every other flag as set. A
    bf16 net's f32 convolutions of bf16 values run under it too, so their
    sums are f32 sums of exact products, as the JAX layer's are. The flag
    is read when a convolution runs, so an exported program's caller sets
    it too (``utils.export.load_exported``)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark,
                   deterministic=c.deterministic, allow_tf32=False)


def check_kernel_choice(choice: Optional[bool],
                        device: Union[str, torch.device], field: str) -> None:
    """Validate a config field that the JAX package named after its Pallas
    kernel (``pallas_nms``; ``crop_method`` read as True / False / None)
    against the engine's device. The device alone routes a stage: its
    wrapper launches the hand-written kernel on a CUDA tensor and takes the
    plain version on a CPU one. None agrees with either device. True asks
    for the kernel, so a CPU engine raises; False asks for the plain
    version, so a CUDA engine raises. A stage never leaves its kernel for
    the plain version on the card."""
    on_card = torch.device(device).type == "cuda"
    if choice is True and not on_card:
        raise ValueError(f"{field} asks for the hand-written CUDA kernel, "
                         f"but the engine runs on {device}: leave it None "
                         "(decided by device) or ask for the plain version")
    if choice is False and on_card:
        raise ValueError(f"{field} asks for the plain version, but the "
                         f"engine runs on {device}, where the stage always "
                         "launches its hand-written kernel: leave it None "
                         "(decided by device) or run the engine on the CPU")
