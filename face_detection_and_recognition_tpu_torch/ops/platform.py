"""Device choice for the port's entry points: the CUDA card unless the caller
asks for the CPU. The counterpart of ``ops/platform.py`` in the JAX package,
which asked whether JAX's default backend was a TPU."""
from __future__ import annotations

from typing import Optional, Union

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
