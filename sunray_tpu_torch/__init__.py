"""sunray_tpu_torch — the PyTorch + CUDA port of sunray_tpu for NVIDIA Hopper.

The JAX package `sunray_tpu` is the reference; this package mirrors its
module and function names and its (P, C) / (H, W, C) layouts at public
functions, and never imports JAX. Plain tensor code is PyTorch; every
Pallas TPU kernel on the ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use and bound with ctypes
(`ops/cuda_build.py`).

Ported so far: the forward frame with `lighting="nee"` (or "brdf") on a
scene small enough for the brute-force tracer, with a trivial texture
atlas. Everything else raises NotImplementedError (render/pipeline.py).

Kernels:
  - K1/K2 brute closest / occlusion trace -> ops/cuda_trace.py, csrc/trace.cu
  - K8 small-table row gather            -> ops/cuda_gather.py, csrc/gather.cu
  - K7 a-trous denoise pass              -> ops/cuda_image.py, csrc/atrous.cu
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
