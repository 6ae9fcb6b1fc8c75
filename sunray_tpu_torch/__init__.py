"""sunray_tpu_torch — the PyTorch + CUDA port of sunray_tpu for NVIDIA Hopper.

The JAX package `sunray_tpu` is the reference; this package mirrors its
module and function names and its (P, C) / (H, W, C) layouts at public
functions, and never imports JAX. Plain tensor code is PyTorch; every
Pallas TPU kernel on the ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use and bound with ctypes
(`ops/cuda_build.py`).

Ported so far: the frame with `lighting="restir"` (the default, shared
spatial taps), "nee" or "brdf", with a trivial texture atlas, on the
brute-force tracer (scenes up to `brute_force_max_tris`) or on the
binned tracer with a ClusterSet accel (`render_frame(..., accel=
ops.binned_trace.build_cluster_set(...))`, any size); forward, or
differentiable (`differentiable=True`: autograd through the frame to the
scene's tensors, e.g. materials and vertex positions, without the
shadow-boundary term). Everything else raises NotImplementedError
(render/pipeline.py, render/trace.py).

Entry points build on the card (`device="cuda"`) unless the caller names
another device; without a card such a call raises.

Kernels:
  - K1/K2 brute closest / occlusion trace -> ops/cuda_trace.py, csrc/trace.cu
  - K8 small-table row gather and its backward
                                         -> ops/cuda_gather.py, csrc/gather.cu
  - K7 a-trous denoise pass              -> ops/cuda_image.py, csrc/atrous.cu
  - K3-K6 ReSTIR audition, temporal and spatial reuse
                                         -> ops/cuda_restir.py, csrc/restir.cu
  - K10-K12 binned trace: block walk, supercluster scan, pair stream
                                         -> ops/cuda_binned.py, csrc/binned.cu
"""

import torch

# Geometry is fp32 multiply-sums; TF32 would quantize vertex positions the
# way bf16 did on the TPU (ROADMAP Queue 3). Both flags stay off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from sunray_tpu_torch.config import RenderConfig  # noqa: E402
from sunray_tpu_torch.camera import Camera, camera_matrices  # noqa: E402

__version__ = "0.1.0"

__all__ = ["RenderConfig", "Camera", "camera_matrices", "__version__"]
