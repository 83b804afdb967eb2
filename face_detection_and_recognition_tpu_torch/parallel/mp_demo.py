"""Multi-process runs: the DP + TP ArcFace step and the fused ensemble with
their mesh spanning several processes.

The counterpart of ``parallel/mp_demo.py`` in the JAX package. Each process
is one rank of a ``torch.distributed`` job (``parallel.mesh.
init_distributed``: NCCL between cards, gloo on the CPU) owning one
device; every rank runs the same function on the same inputs, and the
collectives cross the process boundary as they would cross hosts.

Two ranks on the CPU, by hand:

    python -m face_detection_and_recognition_tpu_torch.parallel.mp_demo \\
        --procs 2 --pid 0 --device cpu &
    python -m face_detection_and_recognition_tpu_torch.parallel.mp_demo \\
        --procs 2 --pid 1 --device cpu

Each prints its result as one JSON line; both ranks hold the same
replicated result, equal to the single-process mesh's (``run_local``).
``--mode ensemble`` runs the BlazeFace-front + MobileFaceNet + age/gender
ensemble over 8 frames split over "data".
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np
import torch

NUM_CLASSES, EMBEDDING = 64, 128


def train_mesh_shape(n: int):
    """The DP + TP mesh of ``n`` devices: "model" 2 when n is even."""
    model_axis = 2 if n % 2 == 0 else 1
    return (n // model_axis, model_axis)


def train_inputs(n: int):
    """The seeded batch: 2 crops for each place on "data"."""
    batch = train_mesh_shape(n)[0] * 2
    images = np.random.RandomState(0).uniform(
        -1, 1, (batch, 112, 112, 3)).astype(np.float32)
    labels = np.random.RandomState(1).randint(0, NUM_CLASSES, (batch,))
    return images, labels


def train_result(mesh, device, steps: int = 2) -> dict:
    """``steps`` DP + TP ArcFace steps on ``mesh`` from the seeded init:
    the last loss and the class kernel's absolute sum (both replicated)."""
    from ..train.arcface import (ArcFaceTrainConfig, create_train_state,
                                 gather_train_state, sharded_train_step)

    cfg = ArcFaceTrainConfig(num_classes=NUM_CLASSES,
                             embedding_size=EMBEDDING)
    state = create_train_state(cfg, torch.Generator().manual_seed(0),
                               device=device)
    step, replicas = sharded_train_step(state, mesh)
    images, labels = train_inputs(mesh.size)
    loss = None
    for _ in range(steps):
        loss = step(images, labels)
    kernel = gather_train_state(replicas, mesh)["arcface_kernel"]
    return {"loss": float(loss), "kernel_sum": float(kernel.abs().sum()),
            "n_devices": mesh.size}


def ensemble_summaries(result) -> dict:
    """Scalar summaries of an EnsembleResult (whole on every rank)."""
    det = result.det
    return {
        "boxes_sum": float(det.boxes.abs().sum()),
        "valid_count": int(det.valid.sum()),
        "crops_sum": float(result.crops.abs().double().sum()),
        "emb_sum": float(result.embeddings.abs().double().sum()),
        "age_sum": float(result.age_probs.abs().double().sum()),
        "gender_sum": float(result.gender_probs.abs().double().sum()),
    }


def ensemble_inputs(n_frames: int = 8, size: int = 128) -> np.ndarray:
    """The seeded BGR frame batch every rank passes whole."""
    return np.random.RandomState(7).randint(
        0, 255, (n_frames, size, size, 3)).astype(np.uint8)


def make_ensemble_engine(device=None):
    from ..core.engine import EngineConfig, FaceEngine

    return FaceEngine(EngineConfig(
        detector="blazeface-front", det_thres=0.3, max_det=4,
        embedder="mobile_facenet", with_age_gender=True), device=device)


def ensemble_result(mesh, device) -> dict:
    engine = make_ensemble_engine(device)
    result = engine.detect_embed_classify_batch(ensemble_inputs(), mesh=mesh)
    out = ensemble_summaries(result)
    out["n_devices"] = mesh.size
    return out


def _warm_collective(mesh) -> None:
    """One small all-reduce over every rank before the long work: each
    rank's first NCCL / gloo connection is made here, not under the skew
    of the ranks' model builds (JAX's ``mp_demo`` does the same for gloo's
    bootstrap deadline)."""
    import torch.distributed as dist

    dev = mesh.device(mesh.local_coords()[0])
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)
    if int(one.item()) != mesh.size:
        raise RuntimeError(f"warm-up all-reduce gave {one.item()}, "
                           f"expected {mesh.size}")


def _run(mode: str, num_processes: int, process_id: int, coordinator: str,
         local_devices: int, steps: int, device, out_path: Optional[str]
         ) -> dict:
    from .mesh import init_distributed, make_mesh, shutdown_distributed

    dev = init_distributed(coordinator, num_processes, process_id,
                           local_cpu_devices=local_devices, device=device)
    try:
        if mode == "ensemble":
            mesh = make_mesh(("data",), (num_processes,))
            _warm_collective(mesh)
            result = ensemble_result(mesh, dev)
        else:
            mesh = make_mesh(("data", "model"),
                             train_mesh_shape(num_processes))
            _warm_collective(mesh)
            result = train_result(mesh, dev, steps)
    finally:
        shutdown_distributed()
    result["process_id"] = process_id
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f)
    return result


def run_worker(num_processes: int, process_id: int,
               coordinator: str = "localhost:29500",
               local_devices: int = 1, steps: int = 2,
               out_path: Optional[str] = None, device=None) -> dict:
    """One rank of a multi-process DP + TP ArcFace job (mesh "data" x
    "model" over the ranks, ``sharded_train_step`` unchanged from the
    single-process path). Returns {"loss", "kernel_sum", "n_devices",
    "process_id"}, the same on every rank."""
    return _run("train", num_processes, process_id, coordinator,
                local_devices, steps, device, out_path)


def run_ensemble_worker(num_processes: int, process_id: int,
                        coordinator: str = "localhost:29500",
                        local_devices: int = 1,
                        out_path: Optional[str] = None, device=None) -> dict:
    """One rank of a multi-process fused-inference job: the ensemble's
    batch split over "data" across the ranks, the result gathered whole
    on each. Returns ``ensemble_summaries`` with "n_devices" and
    "process_id"."""
    return _run("ensemble", num_processes, process_id, coordinator,
                local_devices, 0, device, out_path)


def run_local(n_devices: int, mode: str = "train", steps: int = 2,
              device=None) -> dict:
    """The same job on a single-process mesh of ``n_devices`` entries of
    ``device`` (repeated; the card unless ``"cpu"``): what the ranks'
    result is held to."""
    from ..ops.platform import resolve_device
    from .mesh import canonical_device, make_mesh

    device = canonical_device(resolve_device(device))
    devices = [device] * n_devices
    if mode == "ensemble":
        return ensemble_result(make_mesh(("data",), (n_devices,), devices),
                               device)
    mesh = make_mesh(("data", "model"), train_mesh_shape(n_devices),
                     devices)
    return train_result(mesh, device, steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--coordinator", default="localhost:29500")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="devices a rank: 1 (a rank owns one device)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--mode", choices=("train", "ensemble"), default="train")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="the rank's device: the card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.mode == "ensemble":
        r = run_ensemble_worker(args.procs, args.pid, args.coordinator,
                                args.local_devices, args.out, args.device)
    else:
        r = run_worker(args.procs, args.pid, args.coordinator,
                       args.local_devices, args.steps, args.out, args.device)
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
