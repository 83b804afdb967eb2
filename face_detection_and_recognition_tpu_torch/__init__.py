"""face_detection_and_recognition_tpu_torch — the PyTorch/CUDA port of
``face_detection_and_recognition_tpu`` for NVIDIA Hopper (H100).

The JAX package is the reference; each module here is the counterpart of the
module of the same path there. The port imports neither JAX nor the JAX
package.

Layout:
    ops/        boxes, geometry, preprocess, NMS, and ``cuda_kernels`` (the
                hand-written kernels' wrappers, plain versions and ``fdr``
                operators)
    csrc/       the CUDA C++ kernel sources (sm_90a)
    models/     the yolov5-face network and the detector registry
    core/       the Detections contract and the FaceEngine
    utils/      the flax -> state_dict weight bridge, detect-path profiling,
                model export (``torch.export``)
    parallel/   device meshes, sharded inference and search, training over
                a mesh, multi-process runs
"""
