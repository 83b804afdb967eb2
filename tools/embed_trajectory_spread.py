"""How fast two f32 runs of the golden embedder's training part, on the CPU.

    python tools/embed_trajectory_spread.py [--seed 0] [--steps 50]
        [--every 5] [--eps 1e-7] [--threads 4]

Three runs of the ArcFace step at the golden recipe
(``train/golden_embed.train_golden_embedder``'s defaults: 3 identities,
B = 48, 512-d, s = 16, center gain 0.02, lr 0.01), all from the JAX
package's seed init (bridged by ``utils/weights.py``) and on seed's
crops and batch order: the JAX package's step, the port's step, and the
port's step from the init with each tensor scaled by ``1 + eps * z``
(z standard normal, seeded). Every ``--every`` steps it prints each run's
loss and the relative distance (the norm of the difference over the
norm) of the net's parameters and of the class kernel: the port against
JAX, and the port against its perturbed self. In f64 the two libraries'
steps agree to rounding (``tests/test_torch_arcface_f64.py``); where the
port-against-JAX distance grows as the port-against-perturbed one does,
the runs part by the f32 rounding that training amplifies, and by
nothing else. Imports JAX; runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--every", type=int, default=5)
    ap.add_argument("--eps", type=float, default=1e-7)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from face_detection_and_recognition_tpu.train import arcface as JA
    from face_detection_and_recognition_tpu_torch.models.embedders import (
        get_embedder, preprocess_crops)
    from face_detection_and_recognition_tpu_torch.train import arcface as A
    from face_detection_and_recognition_tpu_torch.train import \
        golden_embed as G
    from face_detection_and_recognition_tpu_torch.utils import weights as W

    torch.set_num_threads(args.threads)
    seed = args.seed
    recipe = dict(num_classes=3, lr=0.01, embedding_size=512, s=16.0,
                  center_gain=0.02)
    spec = get_embedder("mobile_facenet")
    sets = G.identity_train_sets(112, 3, 96, seed, 1.6)
    xs = np.concatenate([np.stack(c) for c in sets]).astype(np.uint8)
    ys = np.concatenate([np.full(len(c), i, np.int32)
                         for i, c in enumerate(sets)])
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(args.steps):
        sel = rng.choice(len(xs), 48, replace=False)
        x = preprocess_crops(spec, torch.from_numpy(xs[sel]).float())
        batches.append((x.numpy(), ys[sel]))

    jst = JA.create_train_state(JA.ArcFaceTrainConfig(**recipe),
                                jax.random.PRNGKey(seed))
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), {
        "params": jst["params"]["net"], "batch_stats": jst["batch_stats"]})
    kernel0 = np.array(jst["params"]["arcface_kernel"], np.float32)

    def port_state(eps):
        st = A.create_train_state(A.ArcFaceTrainConfig(**recipe),
                                  device="cpu")
        sd = W.mobile_facenet_state_dict(v)
        gen = torch.Generator().manual_seed(1234)
        with torch.no_grad():
            for t in list(sd.values()) + [st["arcface_kernel"]]:
                if t.is_floating_point() and eps:
                    t.mul_(1 + eps * torch.randn(t.shape, generator=gen))
        st["net"].load_state_dict(sd)
        with torch.no_grad():
            st["arcface_kernel"].copy_(torch.from_numpy(kernel0))
            if eps:
                st["arcface_kernel"].mul_(1 + eps * torch.randn(
                    kernel0.shape, generator=gen))
        return st

    ports = [port_state(0.0), port_state(args.eps)]
    steps = [A.make_train_step(st) for st in ports]
    jstep = jax.jit(JA.make_train_step(jst))
    p, bs, opt = jst["params"], jst["batch_stats"], jst["opt_state"]

    def flat_net(sd):
        return torch.cat([t.double().flatten() for k, t in sorted(sd.items())
                          if t.is_floating_point() and "running" not in k])

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    print("step  loss jax / port / perturbed  net: port-jax  "
          "port-perturbed  kernel: port-jax  port-perturbed", flush=True)
    for i, (x, y) in enumerate(batches):
        p, bs, opt, jl = jstep(p, bs, opt, jnp.asarray(x), jnp.asarray(y))
        losses = [float(jl)] + [float(s(torch.from_numpy(x),
                                        torch.from_numpy(y)))
                                for s in steps]
        if (i + 1) % args.every and i + 1 != args.steps:
            continue
        jsd = W.mobile_facenet_state_dict(jax.tree_util.tree_map(
            lambda a: np.array(a, np.float32),
            {"params": p["net"], "batch_stats": bs}))
        nets = [flat_net(jsd)] + [flat_net(st["net"].state_dict())
                                  for st in ports]
        kernels = [torch.from_numpy(np.array(p["arcface_kernel"]))
                   .double()] + [st["arcface_kernel"].detach().double()
                                 for st in ports]
        print(f"{i + 1:4d}  {losses[0]:.6f} / {losses[1]:.6f} / "
              f"{losses[2]:.6f}  {rel(nets[1], nets[0]):.3e}  "
              f"{rel(nets[2], nets[1]):.3e}  "
              f"{rel(kernels[1], kernels[0]):.3e}  "
              f"{rel(kernels[2], kernels[1]):.3e}", flush=True)


if __name__ == "__main__":
    main()
