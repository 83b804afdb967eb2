"""optax's Adam and AdamW as ``torch.optim`` optimizers, in optax's update
order.

The JAX package's recognition and graph trainers chain optax transforms
that ``torch.optim.Adam`` / ``AdamW`` do not compose the same way:

- ``optax.adamw(lr, weight_decay=wd)`` (the age/gender, MTCNN and
  BlazeFace trainers): the Adam direction ``m_hat / (sqrt(v_hat) + eps)``, then ``+ wd * p``,
  then times ``-lr``;
- ``optax.chain(clip_by_block_rms(1.0), add_decayed_weights(wd, mask),
  adam(lr))`` (the res10 and OpenVINO graph trainers): each gradient
  divided by ``max(1, rms(g) / threshold)``, tensor by tensor, then ``+ wd
  * p`` on the masked tensors, then Adam (the decay goes through Adam's
  moments, as an L2 term).

``OptaxAdam`` does either, by its ``decoupled`` flag, each parameter group
with its own ``weight_decay``; the moments are updated as optax writes them
(``(1 - b) * g + b * m``) and the bias correction is computed in f32 at the
1-based count. The learning rate is the group's ``lr`` at each ``step()``
(``train.detection.optimizer_step`` sets it from a schedule). A group's
Adam update is a handful of ``torch._foreach_*`` calls over all its
tensors (the block-RMS clip divides tensor by tensor).
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch


class OptaxAdam(torch.optim.Optimizer):
    """Adam in optax's form; ``decoupled=True`` is ``optax.adamw``, False
    the graph trainers' chain (``clip_rms`` clips each tensor's gradient to
    that block RMS first, ``optax.clip_by_block_rms``)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = True,
                 clip_rms: Optional[float] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.decoupled = decoupled
        self.clip_rms = clip_rms

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd, lr = group["weight_decay"], group["lr"]
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["count"] += 1
            sts = [self.state[p] for p in ps]
            g = [p.grad for p in ps]
            if self.clip_rms is not None:
                # rms(g) / threshold, at least 1, tensor by tensor
                den = torch._foreach_norm(g)
                torch._foreach_div_(den, [math.sqrt(t.numel()) * self.clip_rms
                                          for t in g])
                torch._foreach_clamp_min_(den, 1.0)
                g = torch._foreach_div(g, den)
            if wd and not self.decoupled:
                g = torch._foreach_add(g, torch._foreach_mul(ps, wd))
            mu, nu = [st["mu"] for st in sts], [st["nu"] for st in sts]
            # optax's moments: (1 - b) * g + b * m, each product rounded
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
            g2 = torch._foreach_mul(g, g)
            torch._foreach_mul_(g2, 1.0 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, g2)
            # the bias corrections in f32 at the 1-based count
            c1 = [float(f32(1) - f32(b1) ** f32(st["count"])) for st in sts]
            c2 = [float(f32(1) - f32(b2) ** f32(st["count"])) for st in sts]
            u = torch._foreach_div(mu, c1)
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(u, den)
            if wd and self.decoupled:
                torch._foreach_add_(u, torch._foreach_mul(ps, wd))
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(ps, u)
        return None
