"""Device-resident training loop: the example buffer lives on the card and
many optimizer steps run between two host syncs.

The counterpart of ``train/device_loop.py`` in the JAX package, where a
chunk of steps was one jitted ``lax.scan``. Here a chunk is a Python loop of
eager steps on tensors that never leave the device: the augmented examples
are built once on the host (mosaic / HSV / flip from ``train/data.py``) and
uploaded as one uint8 buffer; each step draws a batch's indices, flip mask
and brightness gains from a ``torch.Generator`` on the device, gathers,
flips and scales on the device and runs the family step; the loss and
metrics are summed on the device and read once at the chunk's end.

The JAX package drew from threefry keys, which a torch generator cannot
reproduce; ``make_chunk_trainer`` takes ``draws``, a function of the step
giving (indices, flip mask, gains), so that a test can feed the same draws
to both packages.

A family step is ``step(images_u8, targets, valid) -> (loss, metrics)``
that updates its train state in place (``train/detection.py``,
``train/ssd.py``, ``train/blazeface.py``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .detection import bn_statistics, ema_update_ramped

# landmark column permutation within the 10-wide block after an x-mirror:
# left eye <-> right eye, left mouth corner <-> right mouth corner
_LMK_LR_PERM = [2, 3, 0, 1, 4, 5, 8, 9, 6, 7]

Draws = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def build_example_buffer(index: List[Tuple[str, np.ndarray]], n_examples: int,
                         out_wh: Tuple[int, int], max_targets: int,
                         seed: int = 0, augment=None, to_rgb: bool = True,
                         cache_mb: float = 1200.0
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n_examples`` augmented examples as stacked host arrays (images
    uint8 [K, h, w, 3], targets [K, T, 14], valid [K, T]), ready for one
    upload: the streaming pipeline's mosaic / HSV / flip."""
    from .data import wider_batches

    it = wider_batches(index, batch_size=n_examples, out_wh=out_wh,
                       max_targets=max_targets, seed=seed, epochs=10_000,
                       augment=augment, as_uint8=True, cache_mb=cache_mb,
                       to_rgb=to_rgb)
    x, t, v = next(it)
    it.close()
    return x, t, v


def flip_mask(generator: torch.Generator, b: int, prob: float,
              device) -> torch.Tensor:
    """[b] bool: each example flips with probability ``prob``."""
    return torch.rand(b, generator=generator, device=device) < prob


def brightness_gains(generator: torch.Generator, b: int, jitter: float,
                     device) -> torch.Tensor:
    """[b, 1, 1, 1] gains drawn from U(1 - jitter, 1 + jitter)."""
    u = torch.rand((b, 1, 1, 1), generator=generator, device=device)
    return (1.0 - jitter) + u * (2.0 * jitter)


def device_flip_lr(generator: Optional[torch.Generator], x: torch.Tensor,
                   t: torch.Tensor, prob: float,
                   mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example horizontal flip on the device. x: [B, h, w, 3]; t: [B,
    T, 14] pixel rows (-1 = invisible landmark). Mirrors cx and visible
    landmark xs about the width and swaps the left/right landmark slots
    (``data.flip_lr_targets``'s convention). ``mask`` [B] bool chooses the
    flipped examples; without it the mask is drawn from ``generator``."""
    b, w = x.shape[0], float(x.shape[2])
    if mask is None:
        mask = flip_mask(generator, b, prob, x.device)
    xf = torch.where(mask[:, None, None, None], x.flip(2), x)
    cx = torch.where(mask[:, None], w - t[..., 0], t[..., 0])
    lmk = t[..., 4:14]
    xs = lmk[..., 0::2]
    lmk_m = lmk.clone()
    lmk_m[..., 0::2] = torch.where(xs < 0, -1.0, w - xs)
    lmk_m = lmk_m[..., _LMK_LR_PERM]
    lmk = torch.where(mask[:, None, None], lmk_m, lmk)
    return xf, torch.cat([cx[..., None], t[..., 1:4], lmk], -1)


def device_brightness(generator: Optional[torch.Generator],
                      x_u8: torch.Tensor, jitter: float,
                      gains: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example brightness scale on a uint8 batch (the device's slice of
    HSV-V jitter), clipped and truncated to uint8. ``gains`` [B, 1, 1, 1];
    without them they are drawn from ``generator``."""
    if gains is None:
        gains = brightness_gains(generator, x_u8.shape[0], jitter,
                                 x_u8.device)
    return torch.clamp(x_u8.float() * gains, 0.0, 255.0).to(torch.uint8)


def make_chunk_trainer(step_fn: Callable, state: Dict, batch_size: int,
                       chunk_steps: int, flip_lr: float = 0.5,
                       brightness: float = 0.0,
                       ema_stats_cfg: Optional[Tuple[float, float]] = None,
                       mesh=None,
                       draws: Optional[Callable[[int], Draws]] = None):
    """Wrap a family step into ``chunk(data_x, data_t, data_v, generator)
    -> (loss_mean, metrics_mean)``: ``chunk_steps`` optimizer steps on
    device-resident data with no host sync (the means stay on the device).

    ``ema_stats_cfg=(decay, tau)`` also averages the BatchNorm running
    statistics into ``state["ema"]`` with the ramp the parameters' EMA uses
    (the reference's ModelEMA averages every float buffer; EMA'd weights
    paired with the live statistics are a mismatched net); without it the
    EMA copy takes the live statistics. ``draws(i)`` gives step ``i``'s
    (indices [B], flip mask [B] or None, gains [B, 1, 1, 1] or None) in
    place of the generator's.

    ``mesh``: data-parallel over a device mesh. ``step_fn`` is then a
    ``parallel.training.data_parallel_step`` (its ``replicas`` attribute
    holds the replicated train states), each sampled batch splits over the
    mesh's "data" axis inside it (``batch_size`` must divide the axis), and
    every replica's EMA statistics move with its own live ones: weights,
    EMA and EMA statistics stay replicated."""
    replicas = [state]
    if mesh is not None:
        if batch_size % mesh.shape["data"]:
            raise ValueError(f"batch {batch_size} does not divide over the "
                             f"mesh's {mesh.shape['data']} data shards")
        if not hasattr(step_fn, "replicas"):
            raise ValueError("with a mesh, step_fn is a parallel.training."
                             "data_parallel_step")
        replicas = list(step_fn.replicas.values())
    stats = [(bn_statistics(r["ema"]), bn_statistics(r["net"]), r)
             for r in replicas]

    def chunk(data_x, data_t, data_v, generator=None):
        k = data_x.shape[0]
        loss_sum, metric_sums = None, None
        for i in range(chunk_steps):
            if draws is not None:
                idx, mask, gains = draws(i)
            else:
                idx = torch.randint(0, k, (batch_size,), generator=generator,
                                    device=data_x.device)
                mask = (flip_mask(generator, batch_size, flip_lr,
                                  data_x.device) if flip_lr > 0.0 else None)
                gains = (brightness_gains(generator, batch_size, brightness,
                                          data_x.device)
                         if brightness > 0.0 else None)
            x = data_x.index_select(0, idx)
            t = data_t.index_select(0, idx)
            v = data_v.index_select(0, idx)
            if mask is not None:
                x, t = device_flip_lr(None, x, t, flip_lr, mask)
            if gains is not None:
                x = device_brightness(None, x, brightness, gains)
            loss, metrics = step_fn(x, t, v)
            with torch.no_grad():
                for ema_stats, live_stats, rep in stats:
                    if ema_stats_cfg is not None:
                        ema_update_ramped(ema_stats, live_stats,
                                          rep["n_updates"], *ema_stats_cfg)
                    else:
                        for e, s in zip(ema_stats, live_stats):
                            e.copy_(s)
            if loss_sum is None:
                loss_sum, metric_sums = loss, dict(metrics)
            else:
                loss_sum = loss_sum + loss
                metric_sums = {n: metric_sums[n] + m
                               for n, m in metrics.items()}
        return (loss_sum / chunk_steps,
                {n: m / chunk_steps for n, m in metric_sums.items()})

    return chunk


def weights_of(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A host copy of ``net``'s state dict (a weight candidate)."""
    return {n: t.detach().cpu().clone() for n, t in net.state_dict().items()}


def run_device_training(state: Dict, make_step: Callable,
                        data: Tuple[np.ndarray, np.ndarray, np.ndarray],
                        batch_size: int, max_steps: int,
                        chunk_steps: int = 100, seed: int = 0,
                        flip_lr: float = 0.5, brightness: float = 0.2,
                        on_eval: Optional[Callable[[int, Dict, Dict], bool]]
                        = None, eval_every: int = 200,
                        ema_cfg: Tuple[float, float] = (0.999, 500.0),
                        mesh=None, log=print) -> Dict:
    """Drive chunked device training to ``max_steps``.

    ``on_eval(step, ema_state_dict, live_state_dict)`` is called every
    ``eval_every`` steps (rounded up to chunk boundaries) with both weight
    candidates as host state dicts (each a matched weights + BatchNorm
    statistics pair); returning True stops training. Each chunk's losses
    are appended to ``state["chunk_losses"]``. Returns ``state``, trained
    in place.

    ``mesh``: data-parallel over a device mesh: ``make_step``'s step runs
    on a replica of the state at each coordinate
    (``parallel.training.data_parallel_step``), ``state`` itself the first
    on its device, each batch split over "data" (``batch_size`` must
    divide the axis)."""
    dev = state["device"]
    x, t, v = data
    data_x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    data_t = torch.from_numpy(np.ascontiguousarray(
        t.astype(np.float32))).to(dev)
    data_v = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    log(f"[device-loop] buffer resident: {data_x.nbytes / 1e6:.0f} MB "
        f"images, {data_x.shape[0]} examples")
    gen = torch.Generator(device=dev).manual_seed(seed ^ 0x5EED)
    if mesh is None:
        step = make_step(state)
    else:
        from ..parallel.training import data_parallel_step

        step, _ = data_parallel_step(state, make_step, mesh)
    losses = state.setdefault("chunk_losses", [])
    done, eval_mark = 0, 0
    while done < max_steps:
        steps = min(chunk_steps, max_steps - done)
        chunk = make_chunk_trainer(step, state, batch_size, steps,
                                   flip_lr=flip_lr, brightness=brightness,
                                   ema_stats_cfg=ema_cfg, mesh=mesh)
        loss, metrics = chunk(data_x, data_t, data_v, gen)
        done += steps
        losses.append(float(loss))
        log(f"[device-loop] step {done} loss {losses[-1]:.4f} "
            + " ".join(f"{k} {float(val):.3f}"
                       for k, val in sorted(metrics.items())))
        if on_eval is not None and done - eval_mark >= eval_every:
            eval_mark = done
            if on_eval(done, weights_of(state["ema"]),
                       weights_of(state["net"])):
                break
    return state
