"""Shared helpers for the parity tests of the PyTorch port (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to the JAX function and
to its counterpart in sunray_tpu_torch as numpy arrays.
"""

import dataclasses

import numpy as np
import pytest
import torch

GOLDEN_KW = dict(width=96, height=64, bounces=4, virtual_bounces=3,
                 ris_candidates=8, di_spatial_samples=3, gi_spatial_samples=2,
                 denoise_passes=2, lighting="nee")          # test_golden.py:36-40
CAMERA = dict(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)


def to_numpy(obj):
    """numpy copy of a JAX array or of a (flax) dataclass of them, as the
    nested dicts that sunray_tpu_torch.convert takes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return None if obj is None else np.asarray(obj)


def t(x):
    """numpy/JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def n(x):
    return x.detach().cpu().numpy()


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return np.inf if mse == 0 else 10.0 * np.log10(1.0 / mse)


@pytest.fixture
def cuda_device():
    """The card, or a skip: kernel tests run only where CUDA is present
    (python -m pytest -m gpu tests/test_torch_*.py on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)
