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
