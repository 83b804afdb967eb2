"""Age / gender classification heads (the Levi-Hassner CaffeNet class).

The counterpart of ``models/age_gender.py`` in the JAX package: an 8-bucket
age net and a 2-way gender net, each a 3-conv + 3-fc CaffeNet, run batched
over all face crops at 227x227 with the caffe BGR mean subtracted. The
layers carry the caffemodel's names (``conv1``..``conv3``, ``fc6``..``fc8``),
and fc6 reads conv3's map flattened in caffe's (C, H, W) order, so a
reference ``.caffemodel`` pours in without a permutation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BF16, bf16_scalar, conv_bias_bf16, linear_bias_bf16,
                     set_compute_dtype)

AGE_BUCKETS = (
    "(0-2)", "(4-6)", "(8-12)", "(15-20)", "(25-32)", "(38-43)", "(48-53)",
    "(60-100)"
)
GENDERS = ("Male", "Female")
DROP_KEEP = 0.5  # flax Dropout(0.5)'s keep probability, in train mode


def _lrn(x: torch.Tensor) -> torch.Tensor:
    """Caffe LRN across channels: x / (1 + 1e-4 / 5 * sum_5 x^2) ^ 0.75."""
    if x.dtype == BF16:
        return _lrn_bf16(x)
    return F.local_response_norm(x, 5, alpha=1e-4, beta=0.75, k=1.0)


def _lrn_bf16(x: torch.Tensor, n: int = 5) -> torch.Tensor:
    """The JAX package's LRN on a bf16 NCHW tensor, as XLA computes it:
    the squares rounded to bf16; the window sum accumulated over the n
    channels in order, each partial sum rounded to bf16 (the reduce
    window's bf16 accumulator); then alpha / n (rounded to bf16) times
    it, plus 1, to the 0.75, and the quotient, each rounded to bf16."""
    sq = x * x
    c, half = x.shape[1], n // 2
    pad = F.pad(sq, (0, 0, 0, 0, half, half))
    acc = pad[:, 0:c]
    for j in range(1, n):
        acc = acc + pad[:, j:j + c]
    denom = (acc * bf16_scalar(1e-4 / n) + 1.0) ** 0.75
    return x / denom


class CaffeNetHead(nn.Module):
    """conv 96@7x7/4 -> pool/LRN -> conv 256@5x5 -> pool/LRN -> conv
    384@3x3 -> pool -> fc 512 -> fc 512 -> logits. The pools are caffe's
    ceil-mode 3x3/2 (227 -> 56 -> 28 -> 14 -> 7, fc6 input 384*7*7).
    Takes NCHW. A bf16 input runs the JAX package's bf16 head
    (``models/layers.py``): convolutions and Dense layers with their bias
    in bf16, the logits widened to f32.

    In train mode fc6's and fc7's outputs go through flax's dropout at
    rate 0.5 (``where(keep, x / 0.5, 0)``): ``keep`` is a pair of [N, 512]
    bool masks, or drawn from ``generator`` (``torch.rand < 0.5`` on the
    input's device) when it is None. Inference is untouched."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 96, 7, 4)
        self.conv2 = nn.Conv2d(96, 256, 5, 1, 2)
        self.conv3 = nn.Conv2d(256, 384, 3, 1, 1)
        self.pool = nn.MaxPool2d(3, 2, ceil_mode=True)
        self.fc6 = nn.Linear(384 * 7 * 7, 512)
        self.fc7 = nn.Linear(512, 512)
        self.fc8 = nn.Linear(512, num_classes)

    def forward(self, x: torch.Tensor,
                keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.training:
            return self._train_forward(x, keep, generator)
        if x.dtype == BF16:
            x = _lrn(self.pool(F.relu(conv_bias_bf16(self.conv1, x))))
            x = _lrn(self.pool(F.relu(conv_bias_bf16(self.conv2, x))))
            x = self.pool(F.relu(conv_bias_bf16(self.conv3, x)))
            x = F.relu(linear_bias_bf16(self.fc6, x.flatten(1)))
            x = F.relu(linear_bias_bf16(self.fc7, x))
            return linear_bias_bf16(self.fc8, x).float()
        x = _lrn(self.pool(F.relu(self.conv1(x))))
        x = _lrn(self.pool(F.relu(self.conv2(x))))
        x = self.pool(F.relu(self.conv3(x)))
        x = F.relu(self.fc6(x.flatten(1)))  # (C, H, W) order
        x = F.relu(self.fc7(x))
        return self.fc8(x).float()

    def _train_forward(self, x, keep, generator) -> torch.Tensor:
        if keep is None:
            keep = tuple(torch.rand((x.shape[0], 512), generator=generator,
                                    device=x.device) < DROP_KEEP
                         for _ in range(2))
        x = _lrn(self.pool(F.relu(self.conv1(x))))
        x = _lrn(self.pool(F.relu(self.conv2(x))))
        x = self.pool(F.relu(self.conv3(x)))
        x = F.relu(self.fc6(x.flatten(1)))
        x = torch.where(keep[0], x / DROP_KEEP, 0.0)
        x = F.relu(self.fc7(x))
        x = torch.where(keep[1], x / DROP_KEEP, 0.0)
        return self.fc8(x)


class AgeGenderNet(nn.Module):
    """Both heads over one batch of crops. Takes NHWC [N, 227, 227, 3]
    mean-subtracted BGR crops and returns (age_probs [N, 8], gender_probs
    [N, 2]) f32. ``compute_dtype`` bfloat16 casts the crops to bf16 and
    runs the bf16 heads; the softmax stays f32."""

    def __init__(self):
        super().__init__()
        self.age = CaffeNetHead(len(AGE_BUCKETS))
        self.gender = CaffeNetHead(len(GENDERS))
        self.compute_dtype = torch.float32

    def forward(self, crops: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        # NHWC data -> NCHW channels-last view
        x = crops.permute(0, 3, 1, 2).to(self.compute_dtype)
        return (torch.softmax(self.age(x), -1),
                torch.softmax(self.gender(x), -1))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "AgeGenderNet":
        """Draw every weight from ``generator`` (CPU): conv and linear
        weights from N(0, 2/fan_in), which keeps the scale of ReLU
        activations, and biases 0."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 * (2.0 / fan_in) ** 0.5)
                mod.bias.zero_()
        return self.eval()


def make_age_gender(generator: torch.Generator, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> AgeGenderNet:
    """Both heads with weights drawn from ``generator``, on ``device`` in
    the channels-last memory format, in eval mode, computing in ``dtype``
    (float32 or bfloat16)."""
    net = AgeGenderNet().init_random_(generator)
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    return set_compute_dtype(net, dtype)


def labels_from_probs(age_probs, gender_probs) -> Tuple[str, ...]:
    """'Gender:conf,(age):conf' labels, formatted exactly as the reference
    formats them."""
    out = []
    for a, g in zip(np.asarray(age_probs), np.asarray(gender_probs)):
        gender = GENDERS[int(g.argmax())]
        age = AGE_BUCKETS[int(a.argmax())]
        out.append(f"{gender}:{g.max():.2f},{age}:{a.max():.2f}")
    return tuple(out)
