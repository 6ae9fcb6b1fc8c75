"""PyTorch port on the card: the window forms of K5 and K7 that the
row-sharded frame runs (parallel/spmd.py), on bands of seeded frames.
K5's window kernel is bit-equal to its plain window form, K7's within
1e-5 (each launch counted under its window name), and both window entry
points with row0 0, no halo and h_global = height are the whole-frame
kernels bit for bit. Imports no JAX; skipped without a card:

    python -m pytest --noconftest -m gpu tests/test_torch_window_cuda.py
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread in this process)
from sunray_tpu_torch.ops import cuda_build, cuda_image, cuda_restir
from torch_di_spatial_cases import FIELDS
from torch_parity import cuda_device  # noqa: F401  (fixture)
from torch_window_cases import (
    atrous_guides,
    atrous_window,
    di_spatial_band,
    same_bits,
)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("row0", [0, 94, 282])
def test_di_spatial_window_kernel_bit_equal(row0, cuda_device):
    """K5's window form on 47-row bands of a seeded 333 x 376 frame with
    taps up to the 31-row halo: seeds and every output bit-equal to the
    plain window form."""
    rng = np.random.default_rng(row0)
    taps = [tuple(int(v) for v in rng.integers(-30, 31, 2)) for _ in range(5)]
    _, band, win, _ = di_spatial_band(taps, 70 + row0, 333, 376, row0, 47,
                                      31, cuda_device)
    before = cuda_build.launches["di_spatial_window"]
    seed_k, got = cuda_restir.di_spatial(*band, **win)
    assert cuda_build.launches["di_spatial_window"] == before + 1
    seed_p, want = cuda_restir.di_spatial_plain(*band, **win)
    torch.cuda.synchronize()
    assert torch.equal(seed_k, seed_p)
    for k in FIELDS:
        assert same_bits(got[k], want[k]), k


def test_window_entries_at_row0_are_whole_frame_kernels(cuda_device):
    """sunray_di_spatial_window and sunray_atrous_pass_window with row0 0,
    no halo and h_global = height: the whole-frame kernels' bits."""
    taps = [(-7, 3), (12, -20), (0, 1)]
    _, band, _, _ = di_spatial_band(taps, 3, 200, 120, 0, 120, 0,
                                    cuda_device)
    out_a = cuda_restir._launch_di_spatial(*band)
    out_b = cuda_restir._launch_di_spatial(*band, window=(0, 0, 120))
    torch.cuda.synchronize()
    assert torch.equal(out_a[0], out_b[0])
    for k in FIELDS:
        assert same_bits(out_a[1][k], out_b[1][k]), k
    guides = tuple(g.to(cuda_device) for g in atrous_guides(96, 120, 4))
    for step in (1, 3, 8):
        a = torch.empty_like(guides[0])
        b = torch.empty_like(guides[0])
        cuda_image._launch_pass(*guides, step, a)
        cuda_image._launch_pass(*guides, step, b, window=(0, 96))
        torch.cuda.synchronize()
        assert same_bits(a, b), step


@pytest.mark.parametrize("step", [1, 2, 4, 8])
def test_atrous_window_kernel_matches_plain(step, cuda_device):
    guides = tuple(g.to(cuda_device) for g in atrous_guides(270, 480, step))
    hp = 2 * step
    for row0 in (0, 135, 202):
        win, kw = atrous_window(guides, row0, 68, hp)
        before = cuda_build.launches["atrous_pass_window"]
        got = cuda_image.atrous_pass(*win, step, **kw)
        assert cuda_build.launches["atrous_pass_window"] == before + 1
        want = cuda_image.atrous_denoise_pass(*win, step, **kw)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-5
