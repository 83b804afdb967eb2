"""The int8 convolution of a quantized ConvBN (kernel Q1), its plain PyTorch
version and the dispatch between the two.

The counterpart of the quantized branch of ``ConvBN`` in the JAX package's
``models/layers.py`` (``quantized=True`` / ``"static"``): the activation
scale ``s`` (the absmax of the whole input tensor, or the calibrated
``ascale``), the int8 codes ``clip(round(x / s), -127, 127)``, the
convolution of the codes with the int8 weights accumulated in int32, then
``acc * (s * wscale) + bias`` and SiLU or none.

The JAX package's layer is compiled by XLA, which rewrites two of its
steps; the port computes what the compiled layer computes:

- ``max(absmax, 1e-6) / 127.0`` is a division by a constant, which XLA
  turns into a product with the f32 reciprocal of 127;
- ``acc * (s * wscale) + bias`` is contracted into one fused multiply-add;
- SiLU is ``x * (1 / (1 + exp(-x)))``, JAX's form (``x * sigmoid(x)``),
  not PyTorch's ``x / (1 + exp(-x))``. An int8 net amplifies the ulp
  between the two: an input that an ulp moves across a rounding boundary
  flips its code, and on the golden yolov5n the flips of PyTorch's form
  moved a box by 13 px against the JAX engine's, where JAX's form keeps
  every box within 1 px. The exp stays the platform's own.

``x / s`` stays an IEEE division (``s`` is no constant), and the codes
round half to even. The plain version convolves the codes in float64,
which is exact (|acc| <= 9 * C_in/g * 127^2 < 2^31 < 2^53). On a CUDA
tensor the dispatch launches the hand-written kernel
(``ops.cuda_kernels.conv_int8``, ``csrc/conv_int8.cu``) on the weights
packed by ``pack_kernel_q``; on the CPU it takes the plain version.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_kernels as ck

# the f32 reciprocal of 127, the product XLA makes of "/ 127.0"
RECIP_127 = float(np.float32(1.0) / np.float32(127.0))
ACTS = (None, "silu")  # the activations the kernel fuses, by code
KSTEP = ck.CONV_INT8_KSTEP  # codes of K a stage of csrc/conv_int8.cu


def act_scale(x: torch.Tensor) -> torch.Tensor:
    """The dynamic per-tensor scale of ``x`` (f32 0-d): the absmax over the
    whole tensor, batch included, floored at 1e-6, over 127."""
    return torch.clamp(x.float().abs().amax(), min=1e-6) * RECIP_127


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU in JAX's form, ``x * (1 / (1 + exp(-x)))``."""
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def quantize_codes(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 codes ``clip(round(x / s), -127, 127)``, half to even."""
    return torch.clamp(torch.round(x.float() / s), -127, 127) \
        .to(torch.int8)


def pad_channels4(kernel_q: torch.Tensor) -> torch.Tensor:
    """OHWI int8 weights [C_out, k, k, C] as OHWI4: the input channels
    padded with zero codes to a multiple of 4 (the stem's 3 to 4)."""
    return F.pad(kernel_q, (0, (-kernel_q.shape[-1]) % 4))


def pack_kernel_q(kernel_q: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """The weights in the layout Q1 reads, made once when they reach the
    card. groups == 1: [C_out, kpad] int8, row n the OHWI4 codes of output
    channel n flattened tap-major ((ky, kx), then channels), zero codes
    after them up to a multiple of ``KSTEP``. Depthwise (C/g == 1):
    [k * k, C4], the channels of a tap adjacent, zero past C. Zero codes
    add nothing to the int32 sums."""
    cout, k, _, cg = kernel_q.shape
    if groups > 1:
        w = kernel_q[..., 0].permute(1, 2, 0).reshape(k * k, cout)
        return F.pad(w, (0, (-cout) % 4)).contiguous()
    w = pad_channels4(kernel_q).reshape(cout, -1)
    return F.pad(w, (0, (-w.shape[1]) % KSTEP)).contiguous()


def unpack_kernel_q(wpack: torch.Tensor, k: int, cg: int, cout: int,
                    groups: int = 1) -> torch.Tensor:
    """``pack_kernel_q``'s inverse: the OHWI weights [C_out, k, k, cg]."""
    if groups > 1:
        return wpack[:, :cout].reshape(k, k, cout).permute(2, 0, 1)[
            ..., None].contiguous()
    c4 = cg + (-cg) % 4
    return wpack[:, :k * k * c4].reshape(cout, k, k, c4)[..., :cg] \
        .contiguous()


def conv_int8_plain(x: torch.Tensor, kernel_q: torch.Tensor,
                    wscale: torch.Tensor, bias: torch.Tensor, stride: int,
                    pad: int, groups: int, act: Optional[str],
                    ascale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The quantized ConvBN as torch ops. x: [B, C, H, W] f32 (any memory
    format); kernel_q: [C_out, k, k, C/g] int8 (OHWI); wscale, bias:
    [C_out] f32; ascale: the static scale (0-d f32) or None for the
    dynamic one. Returns [B, C_out, Ho, Wo] f32."""
    s = act_scale(x) if ascale is None else ascale.float()
    xq = quantize_codes(x, s)
    acc = F.conv2d(xq.double(), kernel_q.permute(0, 3, 1, 2).double(),
                   None, stride, pad, 1, groups).to(torch.int32)
    shape = (1, -1, 1, 1)
    pre = ck._fma_f32(acc.float(), (s * wscale).reshape(shape),
                      bias.reshape(shape).expand_as(acc))
    return silu(pre) if act == "silu" else pre


def conv_int8_packed_plain(x: torch.Tensor, wpack: torch.Tensor,
                           wscale: torch.Tensor, bias: torch.Tensor, k: int,
                           stride: int, pad: int, groups: int,
                           act: Optional[str],
                           ascale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``conv_int8_plain`` on ``ck.conv_int8``'s arguments (the packed
    weights): Q1's plain version, call for call."""
    kq = unpack_kernel_q(wpack, k, x.shape[1] // groups, wscale.shape[0],
                         groups)
    return conv_int8_plain(x, kq, wscale, bias, stride, pad, groups, act,
                           ascale)


def conv_int8(x: torch.Tensor, kernel_q: torch.Tensor, wscale: torch.Tensor,
              bias: torch.Tensor, stride: int, pad: int, groups: int,
              act: Optional[str], ascale: Optional[torch.Tensor] = None,
              wpack: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The quantized ConvBN: Q1 (``csrc/conv_int8.cu``) on a CUDA tensor,
    ``conv_int8_plain`` on the CPU. Same arguments and result; ``wpack``
    is ``pack_kernel_q(kernel_q, groups)`` where the caller keeps it (else
    it is made here)."""
    if act not in ACTS:
        raise ValueError(f"conv_int8: activation {act!r} is not one of "
                         f"{ACTS}")
    if x.device.type == "cpu":
        return conv_int8_plain(x, kernel_q, wscale, bias, stride, pad,
                               groups, act, ascale)
    if wpack is None:
        wpack = pack_kernel_q(kernel_q, groups)
    return ck.conv_int8(x, wpack, wscale, bias, kernel_q.shape[1], stride,
                        pad, groups, act, ascale)
