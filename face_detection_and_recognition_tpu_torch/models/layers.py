"""The yolov5-face, BlazeFace and MobileFaceNet building blocks as PyTorch
modules.

The counterparts of ``models/layers.py`` in the JAX package. Submodules carry
the reference torch names (``conv``/``bn``, ``cv1``..``cv3``, ``m``,
``stem_*``, ``convs``), so a network's ``state_dict`` keys are those of a
reference checkpoint. Tensors are NCHW; the network keeps them in the
channels-last memory format.

bfloat16: a layer given a bf16 tensor computes what the JAX package's layer
built with ``dtype=jnp.bfloat16`` computes, as XLA compiles it on the CPU
(read from its optimized HLO). Parameters stay f32 and are rounded to bf16
where flax casts them (``bf16_param`` keeps the rounded copy until the
parameter changes). The rounding points:

- a convolution or Dense followed by a BatchNorm: bf16 inputs and weights,
  products exact and sums in f32, NOT rounded (XLA keeps the sums of
  ``lax.conv`` in f32 where the BatchNorm promotes them to f32:
  ``conv_sums``, ``linear_sums``); the BatchNorm in f32 from the running
  statistics, ``(s - mean) * (rsqrt(var + eps) * scale) + bias``, rounded
  once to bf16 (``batch_norm_bf16``);
- a convolution or Dense with a bias: the sums rounded to bf16, then the
  bias, rounded to bf16, added in bf16 (``conv_bias_bf16``,
  ``linear_bias_bf16``): two roundings;
- every elementwise op on bf16 values rounds its result to bf16: SiLU is
  ``x * (1 / (1 + exp(-x)))`` with four roundings (``silu_bf16``), PReLU's
  product one, a residual add one; ReLU, ReLU6, max pools, concatenation,
  nearest upsampling and the channel shuffle are exact;
- XLA drops the bf16 rounding of a result whose only use is its cast to
  f32 (the convert pair folds away): a head whose output is cast to f32
  at once keeps its f32 sum (``models/mtcnn.py``), and one reshaped first
  rounds (the SSD and BlazeFace heads).

On the card the f32 sums of bf16 values come from an f32 convolution of
the bf16 values (TF32 off: every product of two bf16 values is exact in
f32), the rounded ones from cuDNN's bf16 convolution, which accumulates in
f32 and rounds once. A layer takes its bf16 path when its input is bf16;
a net casts its input to its ``compute_dtype`` (``set_compute_dtype``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cuda_kernels as ck
from ..ops.int8_conv import RECIP_127, conv_int8, pack_kernel_q

BF16 = torch.bfloat16

# the reduction over the whole batch of a sharded run (global_batch)
_batch = threading.local()


@contextlib.contextmanager
def global_batch(reduce: Callable[[torch.Tensor, str], torch.Tensor],
                 shards: int):
    """Within the block, in the calling thread, the batch a layer sees is
    one of ``shards`` equal shards of a larger batch, and ``reduce(t,
    op)`` sums (``"sum"``) or maxes (``"max"``) ``t`` over all of them
    (``parallel.collectives.reduce_batch``). The layers whose result
    depends on the whole batch use it, as the JAX package's single
    program over a sharded batch does: a training BatchNorm normalizes
    with the whole batch's statistics (``flax_batch_norm_train``), and a
    dynamic int8 ConvBN quantizes with the whole batch's absmax
    (``QConvBN``)."""
    prev = getattr(_batch, "hook", None)
    _batch.hook = (reduce, int(shards))
    try:
        yield
    finally:
        _batch.hook = prev


def batch_reduction():
    """(reduce, shards) of the enclosing ``global_batch``, or None."""
    return getattr(_batch, "hook", None)


def bf16_param(module: nn.Module, name: str,
               dtype: torch.dtype = BF16) -> torch.Tensor:
    """``module``'s parameter or buffer ``name`` rounded to bf16 (and, for
    ``dtype`` float32, widened back: the bf16 value as an f32 tensor),
    kept on the module until the tensor is replaced or written in place
    (its version moves)."""
    t = getattr(module, name)
    if ck.exporting():  # a fake tensor, not to be kept
        return t.detach().to(BF16).to(dtype)
    cache = module.__dict__.setdefault("_bf16_params", {})
    hit = cache.get((name, dtype))
    if hit is not None and hit[0] is t and hit[1] == t._version:
        return hit[2]
    r = t.detach().to(BF16).to(dtype)
    cache[(name, dtype)] = (t, t._version, r)
    return r


def _bn_form(bn: nn.Module):
    """(mean, mul, bias) of a BatchNorm in inference, f32 [C]: the
    ``rsqrt(var + eps) * scale`` of flax's ``_normalize``, kept until a
    statistic or parameter changes."""
    deps = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    key = tuple((id(t), t._version) for t in deps if t is not None)
    hit = bn.__dict__.get("_bf16_form")
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        mul = torch.rsqrt(bn.running_var + bn.eps)
        if bn.weight is not None:
            mul = mul * bn.weight
        bias = (bn.bias.detach() if bn.bias is not None
                else torch.zeros_like(mul))
        form = (bn.running_mean.detach().clone(), mul, bias.clone())
    bn.__dict__["_bf16_form"] = (key, form)
    return form


def conv_sums(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The f32 sums of ``conv`` (no bias) on ``x`` and the weights, both
    rounded to bf16: exact products, f32 sums, no rounding after."""
    return F.conv2d(x.to(BF16).float(),
                    bf16_param(conv, "weight", torch.float32), None,
                    conv.stride, conv.padding, conv.dilation, conv.groups)


def conv_bias_bf16(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Conv(dtype=bf16)`` with a bias: the bf16 convolution (f32
    sums rounded once), then the bf16 bias added in bf16."""
    y = F.conv2d(x.to(BF16), bf16_param(conv, "weight"), None, conv.stride,
                 conv.padding, conv.dilation, conv.groups)
    return y + bf16_param(conv, "bias").view(1, -1, 1, 1)


def conv_bias(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A convolution with its bias: ``conv(x)``, or on a bf16 ``x``
    ``conv_bias_bf16``."""
    return conv_bias_bf16(conv, x) if x.dtype == BF16 else conv(x)


def prelu_bf16(prelu: nn.PReLU, h: torch.Tensor) -> torch.Tensor:
    """flax's ``where(h >= 0, h, h * alpha)`` on a bf16 ``h`` (channels on
    dim 1), alpha rounded to bf16: the product rounded once."""
    shape = (1, -1) + (1,) * (h.dim() - 2)
    return torch.where(h >= 0, h, h * bf16_param(prelu, "weight")
                       .view(shape))


def linear_sums(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """The f32 sums of ``lin`` (no bias) on ``x`` and the weights rounded
    to bf16, as ``conv_sums``: an f32 product of the bf16 values, so the
    sums stay f32 on the card whatever cuBLAS may do with bf16 operands."""
    return F.linear(x.to(BF16).float(),
                    bf16_param(lin, "weight", torch.float32))


def linear_bias_bf16(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.Dense(dtype=bf16)`` with a bias: the f32 sums rounded to
    bf16, then the bf16 bias added in bf16."""
    return linear_sums(lin, x).to(BF16) + bf16_param(lin, "bias")


def batch_norm_bf16(bn: nn.Module, s: torch.Tensor) -> torch.Tensor:
    """flax ``BatchNorm(dtype=bf16)`` from its running statistics on ``s``
    (f32 sums, or a bf16 tensor), channels on dim 1: computed in f32 and
    rounded once to bf16."""
    mean, mul, bias = _bn_form(bn)
    shape = (1, -1) + (1,) * (s.dim() - 2)
    return ((s.float() - mean.view(shape)) * mul.view(shape)
            + bias.view(shape)).to(BF16)


def silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """JAX's SiLU ``x * (1 / (1 + exp(-x)))`` on a bf16 tensor, each of the
    four results rounded to bf16, as XLA computes it."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def act_bf16(act: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The activation module ``act`` on a bf16 tensor: SiLU in JAX's
    rounded form, the others (ReLU, ReLU6, Identity) exact as they are."""
    return silu_bf16(x) if isinstance(act, nn.SiLU) else act(x)


def mean_hw_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` over the spatial axes of a bf16 NCHW tensor, as XLA
    computes it: f32 sums times the f32 reciprocal of the count, rounded
    to bf16."""
    n = x.shape[-1] * x.shape[-2]
    return (x.float().sum((2, 3)) * float(np.float32(1.0) / np.float32(n))
            ).to(BF16)


def bf16_scalar(v: float) -> float:
    """A Python scalar as flax's bf16 arithmetic reads it: rounded to
    bf16 (a weak-typed scalar takes the array's type)."""
    return float(torch.tensor(v).to(BF16))


def sequence_bf16(mods, x: torch.Tensor) -> torch.Tensor:
    """An ``nn.Sequential`` of (Conv2d without bias, BatchNorm2d) pairs and
    activations on a bf16 tensor: each pair as ``conv_sums`` then
    ``batch_norm_bf16``, each activation as ``act_bf16``."""
    mods = list(mods)
    i = 0
    while i < len(mods):
        m = mods[i]
        if isinstance(m, nn.Conv2d) and m.bias is None and i + 1 < len(mods) \
                and isinstance(mods[i + 1], nn.BatchNorm2d):
            x = batch_norm_bf16(mods[i + 1], conv_sums(m, x))
            i += 2
            continue
        if isinstance(m, nn.Conv2d):
            raise TypeError("sequence_bf16: a Conv2d must be bias-free and "
                            "followed by its BatchNorm2d")
        x = act_bf16(m, x)
        i += 1
    return x


def set_compute_dtype(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set ``compute_dtype`` on ``net`` and every submodule that has one
    (the nets cast their input to it; the yolov5 Detect layer casts its
    own): float32, or bfloat16 for the JAX package's bf16 nets."""
    if dtype not in (torch.float32, BF16):
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16")
    for m in net.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return net


def flax_batch_norm_train(bn: nn.modules.batchnorm._BatchNorm,
                          x: torch.Tensor, dims: Tuple[int, ...]
                          ) -> torch.Tensor:
    """flax ``BatchNorm``'s training forward (``use_fast_variance``) with
    ``bn``'s parameters over the reduced ``dims`` (the channel axis is
    1): the batch mean and the biased variance ``max(E[x^2] - E[x]^2, 0)``
    normalize the batch as ``(x - mean) * (rsqrt(var + eps) * weight) +
    bias``, and the running statistics move toward them, ``ra * (1 -
    momentum) + stat * momentum``, the running variance toward the biased
    variance. In f32, or f64 for an f64 input. Inside ``global_batch``
    the statistics are the whole batch's: the shards' sums of ``x`` and
    ``x^2`` reduced over the shards (the gradient flows back through the
    reduction)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    hook = batch_reduction()
    if hook is None:
        mean = xf.mean(dims)
        mean2 = (xf * xf).mean(dims)
    else:
        reduce, shards = hook
        n = math.prod(x.shape[d] for d in dims) * shards
        sums = reduce(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]),
                      "sum") / n
        mean, mean2 = sums[0], sums[1]
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach() * m)
        bn.running_var.mul_(1.0 - m).add_(var.detach() * m)
        bn.num_batches_tracked.add_(1)
    shape = [1, -1] + [1] * (x.dim() - 2)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((xf - mean.view(shape)) * mul.view(shape)
            + bn.bias.view(shape)).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training forward is flax ``BatchNorm``'s
    (``flax_batch_norm_train``): the running variance moves toward the
    biased variance (``nn.BatchNorm2d`` moves it toward the unbiased one,
    n / (n - 1) larger). The form is written out in elementwise ops:
    ``F.batch_norm``'s fused training kernel on the card put a step's
    parameters up to 3e-3 of their scale from the CPU's. Inference, and a
    ``momentum`` of None (the cumulative average the seeded nets use to
    set their statistics from one batch), are ``nn.BatchNorm2d``'s own.
    flax's ``momentum`` m is this module's ``1 - m``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        return flax_batch_norm_train(self, x, (0, 2, 3))


class BatchNorm1d(nn.BatchNorm1d):
    """``BatchNorm2d``'s flax training form for [N, C] features (the
    embedders' last BatchNorm after their Dense)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.momentum is None:
            return super().forward(x)
        return flax_batch_norm_train(self, x, (0,))


def freeze_scale(bn: nn.modules.batchnorm._BatchNorm
                 ) -> nn.modules.batchnorm._BatchNorm:
    """A BatchNorm without a scale (flax ``use_scale=False``): its weight
    stays 1, neither trained nor decayed (no gradient)."""
    bn.weight.requires_grad_(False)
    return bn


class _JaxClip(torch.autograd.Function):
    """``jnp.clip(x, lo, hi)``, its gradient as JAX's: ``maximum(lo, x)``
    then ``minimum(hi, .)``, each passing ``g`` times 1 inside, 0.5 at a
    tie and 0 outside, by multiplication (so a NaN or inf ``g`` outside
    the bounds stays NaN, where ``torch.clamp`` writes 0)."""

    @staticmethod
    def forward(ctx, x, lo: float, hi: float):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.minimum(torch.maximum(x, x.new_tensor(lo)),
                             x.new_tensor(hi))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        y = torch.maximum(x, x.new_tensor(lo))
        w_min = torch.where(y < hi, 1.0, torch.where(y == hi, 0.5, 0.0))
        w_max = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
        return g * w_min * w_max, None, None


def jax_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with JAX's gradient at and beyond the bounds (a value
    at a bound takes half the gradient; ``torch.clamp`` passes all of
    it). Where no gradient is taken it is ``torch.clamp``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _JaxClip.apply(x, lo, hi)
    return x.clamp(lo, hi)


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same' padding for odd kernels."""
    return k // 2 if p is None else p


def make_divisible_torch(x: float, divisor: int) -> int:
    """Channel-width rounding of the reference's parse_model: ceil to a
    multiple of ``divisor``."""
    return int(math.ceil(x / divisor) * divisor)


def param_key(name: str) -> str:
    """A file's layer or constant name as a module or parameter name:
    percent-encoded, so that '.' and '/' (which ``nn.Module`` names
    refuse or split on) become '%2E' and '%2F', one to one."""
    return (name.replace("%", "%25").replace(".", "%2E")
            .replace("/", "%2F"))


def param_unkey(key: str) -> str:
    """The file name ``param_key`` encoded."""
    return key.replace("%2E", ".").replace("%2F", "/").replace("%25", "%")


_ACTS = {"silu": nn.SiLU, "relu": nn.ReLU, "relu6": nn.ReLU6,
         None: nn.Identity}


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + activation: the yolov5 ``Conv``. The
    BN epsilon is the JAX package's 1e-3, not PyTorch's default 1e-5, and
    its training form flax's (``BatchNorm2d``).
    ``groups`` and ``act`` ("silu", "relu", "relu6" or None for a linear
    output) serve the SSD trunks; the defaults are the yolov5 ``Conv``."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, groups: int = 1,
                 act: Optional[str] = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, autopad(k, p), groups=groups,
                              bias=False)
        self.bn = BatchNorm2d(c_out, eps=1e-3, momentum=0.03)
        self.act = _ACTS[act]()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:
            return act_bf16(self.act, batch_norm_bf16(self.bn,
                                                      conv_sums(self.conv, x)))
        return self.act(self.bn(self.conv(x)))


class QConvBN(nn.Module):
    """The int8 ConvBN (the JAX package's ``ConvBN(quantized=True |
    "static")``): BN folded into per-output-channel int8 weights
    ``kernel_q`` [C_out, k, k, C_in / g] (OHWI) with scales ``wscale`` and
    a ``bias``; the input quantized per tensor, from its absmax over the
    whole batch or, ``static``, from the calibrated ``ascale``; the codes
    convolved into int32 sums (``ops.int8_conv.conv_int8``: the Q1 kernel
    on the card), then dequantized, biased and passed through SiLU or
    none. ``utils.quantize`` builds the weights. On the card the kernel
    reads them packed (``pack_kernel_q``), packed once for each new or
    changed ``kernel_q``. A bf16 input is widened to f32 first, as the JAX
    layer does (``x.astype(f32)``); the output is f32 in either case.
    Inside ``global_batch`` a dynamic layer's scale is the whole batch's
    absmax (the shards' absmaxes reduced), given to the kernel as a static
    scale: the codes of the unsharded batch."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: Optional[int] = None, groups: int = 1,
                 act: Optional[str] = "silu", static: bool = False):
        super().__init__()
        self.stride, self.pad, self.groups, self.act = s, autopad(k, p), \
            groups, act
        self.register_buffer("kernel_q", torch.zeros(
            (c_out, k, k, c_in // groups), dtype=torch.int8))
        self.register_buffer("wscale", torch.ones(c_out))
        self.register_buffer("bias", torch.zeros(c_out))
        self.register_buffer("ascale", torch.ones(()) if static else None)
        self._wpack = self._wpack_of = None

    def _apply(self, fn, *args, **kwargs):
        # Module.to(memory_format=channels_last) restrides every 4-D
        # buffer; the kernel reads the codes as dense OHWI
        out = super()._apply(fn, *args, **kwargs)
        self.kernel_q = self.kernel_q.contiguous()
        return out

    def __getstate__(self):
        # the packed weights are a cache of kernel_q that carries Q1's
        # launch record (ctypes): a copy, a replica on another card, packs
        # its own
        state = dict(super().__getstate__())
        state["_wpack"] = state["_wpack_of"] = None
        return state

    def _packed(self) -> Optional[torch.Tensor]:
        """Q1's packed weights for the current ``kernel_q`` (None on the
        CPU): made again after ``to()`` or a weight load, which replace the
        tensor or bump its version. An inference tensor has no version:
        its pack is made every call."""
        kq = self.kernel_q
        if ck.exporting():
            # kernel_q is a fake tensor here, not to be cached: the program
            # owns the packed weights (export_packed)
            wpack = self._buffers.get("wpack")
            if wpack is None:
                raise RuntimeError("QConvBN: a program is exported outside "
                                   "export_packed")
            return wpack
        if kq.device.type == "cpu":
            return None
        if kq.is_inference():
            return pack_kernel_q(kq, self.groups)
        of = self._wpack_of
        if of is None or of[0] is not kq or of[1] != kq._version:
            self._wpack = pack_kernel_q(kq, self.groups)
            self._wpack_of = (kq, kq._version)
        return self._wpack

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        ascale, hook = self.ascale, batch_reduction()
        if ascale is None and hook is not None:
            absmax = hook[0](x.abs().amax(), "max")
            ascale = torch.clamp(absmax, min=1e-6) * RECIP_127
        return conv_int8(x, self.kernel_q, self.wscale, self.bias,
                         self.stride, self.pad, self.groups, self.act,
                         ascale, self._packed())


@contextlib.contextmanager
def export_packed(module: nn.Module):
    """Within, each ``QConvBN`` under ``module`` holds its packed weights
    as a buffer (``wpack``, not in the state dict), which ``_packed``
    hands Q1 while a program is exported: the program then owns them as
    it owns ``kernel_q``, and Q1's launch record, kept on them, is made at
    its first call and not at every one."""
    layers = [m for m in module.modules() if isinstance(m, QConvBN)]
    for m in layers:
        with torch.no_grad():
            m.register_buffer("wpack", pack_kernel_q(m.kernel_q, m.groups),
                              persistent=False)
    try:
        yield
    finally:
        for m in layers:
            del m._buffers["wpack"]


def conv_bn(c_in: int, c_out: int, k: int = 1, s: int = 1,
            p: Optional[int] = None, groups: int = 1,
            act: Optional[str] = "silu", quantized=False) -> nn.Module:
    """A ConvBN, or its int8 form when ``quantized`` (True: dynamic
    activation scales; "static": calibrated ones)."""
    if quantized:
        return QConvBN(c_in, c_out, k, s, p, groups, act,
                       static=quantized == "static")
    return ConvBN(c_in, c_out, k, s, p, groups, act)


class Bottleneck(nn.Module):
    """Standard bottleneck, with a residual when shapes allow."""

    def __init__(self, c_in: int, c_out: int, shortcut: bool = True,
                 e: float = 0.5, quantized=False):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = conv_bn(c_in, c_, 1, 1, quantized=quantized)
        self.cv2 = conv_bn(c_, c_out, 3, 1, quantized=quantized)
        self.add = shortcut and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs."""

    def __init__(self, c_in: int, c_out: int, n: int = 1,
                 shortcut: bool = True, e: float = 0.5, quantized=False):
        super().__init__()
        c_ = int(c_out * e)
        self.cv1 = conv_bn(c_in, c_, 1, 1, quantized=quantized)
        self.cv2 = conv_bn(c_in, c_, 1, 1, quantized=quantized)
        self.cv3 = conv_bn(2 * c_, c_out, 1, quantized=quantized)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, e=1.0,
                                            quantized=quantized)
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    """Spatial pyramid pooling: stride-1 'same' max pools of several sizes."""

    def __init__(self, c_in: int, c_out: int,
                 kernels: Sequence[int] = (5, 9, 13), quantized=False):
        super().__init__()
        c_ = c_in // 2
        self.cv1 = conv_bn(c_in, c_, 1, 1, quantized=quantized)
        self.cv2 = conv_bn(c_ * (len(kernels) + 1), c_out, 1, 1,
                           quantized=quantized)
        self.m = nn.ModuleList(nn.MaxPool2d(k, 1, k // 2) for k in kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [m(x) for m in self.m], 1))


class StemBlock(nn.Module):
    """PeleeNet-style stem; its 2x2 max pool rounds up (ceil_mode), as the
    JAX package's SAME-padded pool does."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, s: int = 2,
                 quantized=False):
        super().__init__()
        q = dict(quantized=quantized)
        self.stem_1 = conv_bn(c_in, c_out, k, s, **q)
        self.stem_2a = conv_bn(c_out, c_out // 2, 1, 1, 0, **q)
        self.stem_2b = conv_bn(c_out // 2, c_out, 3, 2, 1, **q)
        self.stem_2p = nn.MaxPool2d(2, 2, ceil_mode=True)
        self.stem_3 = conv_bn(c_out * 2, c_out, 1, 1, 0, **q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s1 = self.stem_1(x)
        s2 = self.stem_2b(self.stem_2a(s1))
        return self.stem_3(torch.cat([s2, self.stem_2p(s1)], 1))


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet channel shuffle of NCHW ``x``: channel j of the output is
    channel (j % groups) * (C / groups) + j // groups of the input. A
    channels-last ``x`` gives a channels-last result (the permutation made
    within each pixel's NHWC row), so the next layers read it in place."""
    b, c, h, w = x.shape
    if x.dim() == 4 and not x.is_contiguous() \
            and x.is_contiguous(memory_format=torch.channels_last):
        return x.permute(0, 2, 3, 1).reshape(b, h, w, groups, c // groups) \
            .transpose(3, 4).reshape(b, h, w, c).permute(0, 3, 1, 2)
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(b, c, h, w)


def _conv_bn(c_in: int, c_out: int, k: int, s: int, groups: int = 1):
    """(Conv2d without bias, BatchNorm) of a ShuffleV2 branch; BN epsilon
    1e-3, the JAX package's ConvBN."""
    return (nn.Conv2d(c_in, c_out, k, s, k // 2, groups=groups, bias=False),
            BatchNorm2d(c_out, eps=1e-3, momentum=0.03))


class ShuffleV2Block(nn.Module):
    """ShuffleNetV2 unit with SiLU activations (yolov5n). The branches are
    the reference's ``nn.Sequential``s, so their indices are its state_dict
    names: branch1 = (dw conv, bn, conv, bn, SiLU) when strided, branch2 =
    (conv, bn, SiLU, dw conv, bn, conv, bn, SiLU). ``quantized``: each
    (conv, bn) pair is one ``QConvBN`` (the depthwise ones linear), so
    branch1 = (dw, 1x1) and branch2 = (1x1, dw, 1x1)."""

    def __init__(self, c_in: int, c_out: int, stride: int, quantized=False):
        super().__init__()
        self.stride = stride
        bf = c_out // 2
        c2 = c_in if stride > 1 else c_in // 2
        if quantized:
            q = dict(quantized=quantized)
            self.branch1 = nn.Sequential(
                conv_bn(c_in, c_in, 3, stride, 1, c_in, None, **q),
                conv_bn(c_in, bf, 1, 1, 0, **q)) if stride > 1 \
                else nn.Sequential()
            self.branch2 = nn.Sequential(
                conv_bn(c2, bf, 1, 1, 0, **q),
                conv_bn(bf, bf, 3, stride, 1, bf, None, **q),
                conv_bn(bf, bf, 1, 1, 0, **q))
            return
        if stride > 1:
            self.branch1 = nn.Sequential(*_conv_bn(c_in, c_in, 3, stride, c_in),
                                         *_conv_bn(c_in, bf, 1, 1), nn.SiLU())
        else:
            self.branch1 = nn.Sequential()
        self.branch2 = nn.Sequential(
            *_conv_bn(c2, bf, 1, 1), nn.SiLU(),
            *_conv_bn(bf, bf, 3, stride, bf), *_conv_bn(bf, bf, 1, 1),
            nn.SiLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def run(branch, v):
            if v.dtype == BF16 and not isinstance(branch[0], QConvBN):
                return sequence_bf16(branch, v)
            return branch(v)

        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, run(self.branch2, x2)], 1)
        else:
            out = torch.cat([run(self.branch1, x), run(self.branch2, x)], 1)
        return channel_shuffle(out, 2)


# ---------------- BlazeFace blocks ----------------


def _blaze_convs(c_in: int, c_out: int, k: int, stride: int, pad: int
                 ) -> nn.Sequential:
    """Depthwise k x k conv, then 1x1 conv, both with bias (the TFLite
    export folded BN into them): the reference's ``convs``."""
    return nn.Sequential(
        nn.Conv2d(c_in, c_in, k, stride, pad, groups=c_in, bias=True),
        nn.Conv2d(c_in, c_out, 1, bias=True))


def _separable(convs: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
    """The depthwise then pointwise convolution of ``convs``, each with its
    bias (on bf16: each rounded twice, ``conv_bias``)."""
    return conv_bias(convs[1], conv_bias(convs[0], h))


class BlazeBlock(nn.Module):
    """Depthwise-separable residual block with TFLite stride-2 padding.

    Stride 2: the depthwise conv reads x padded by (0, 2, 0, 2) with no
    padding of its own, and the residual is max-pooled 2x2; a channel
    deficit of the residual is zero-padded."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.c_pad = c_out - c_in
        self.convs = _blaze_convs(c_in, c_out, k, stride,
                                  0 if stride == 2 else (k - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            h, res = F.pad(x, (0, 2, 0, 2)), F.max_pool2d(x, 2, 2)
        else:
            h, res = x, x
        if self.c_pad > 0:
            res = F.pad(res, (0, 0, 0, 0, 0, self.c_pad))
        return F.relu(_separable(self.convs, h) + res)


class FinalBlazeBlock(nn.Module):
    """Stride-2 separable block without residual (BlazeFace back's
    ``final``)."""

    def __init__(self, channels: int, k: int = 3):
        super().__init__()
        self.convs = _blaze_convs(channels, channels, k, 2, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(_separable(self.convs, F.pad(x, (0, 2, 0, 2))))


# ---------------- MobileFaceNet blocks ----------------


class MFConvBlock(nn.Module):
    """Conv (no bias) + BN + per-channel PReLU: the reference's
    ``Conv_block`` (``conv``, ``bn``, ``prelu``). BN epsilon 1e-5; in
    train mode flax's BatchNorm at its default momentum 0.99."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: int = 0, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, p, groups=groups, bias=False)
        self.bn = BatchNorm2d(c_out, eps=1e-5, momentum=0.01)
        self.prelu = nn.PReLU(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:
            return prelu_bf16(self.prelu, batch_norm_bf16(
                self.bn, conv_sums(self.conv, x)))
        return self.prelu(self.bn(self.conv(x)))


class MFLinearBlock(nn.Module):
    """Conv (no bias) + BN, no activation: the reference's
    ``Linear_block``. The BN as ``MFConvBlock``'s."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 p: int = 0, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, p, groups=groups, bias=False)
        self.bn = BatchNorm2d(c_out, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == BF16:
            return batch_norm_bf16(self.bn, conv_sums(self.conv, x))
        return self.bn(self.conv(x))


class MFDepthWise(nn.Module):
    """Pointwise expand to ``groups`` channels -> depthwise 3x3 -> linear
    project to ``c_out``, with an optional residual: the reference's
    ``Depth_Wise`` (``conv``, ``conv_dw``, ``project``)."""

    def __init__(self, c_in: int, c_out: int, groups: int, stride: int = 2,
                 residual: bool = False):
        super().__init__()
        self.conv = MFConvBlock(c_in, groups, 1)
        self.conv_dw = MFConvBlock(groups, groups, 3, stride, 1, groups=groups)
        self.project = MFLinearBlock(groups, c_out, 1)
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.conv_dw(self.conv(x)))
        return x + y if self.residual else y


def l2_normalize(x: torch.Tensor, axis: Optional[int] = None,
                 eps: float = 1e-12, *, dim: Optional[int] = None
                 ) -> torch.Tensor:
    """x / max(||x||, eps) along ``axis`` (the JAX package's name; ``dim``
    is accepted as well), the last one by default."""
    if axis is not None and dim is not None and axis != dim:
        raise ValueError(f"l2_normalize: axis={axis} and dim={dim} differ")
    d = -1 if axis is None and dim is None else (
        axis if axis is not None else dim)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=d, keepdim=True),
                           min=eps)
