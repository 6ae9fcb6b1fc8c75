"""The host side of the kernel launches, on the CPU with stand-in libraries.

K14's, K2's, K1's, K3's and K7's launch shapes: the host's copies
(cuda_trace.WOOP_RAYS, WOOP_THREADS, OCC_RAYS, OCC_THREADS, OCC_WIDE_MIN,
CLOSEST_RAYS, CLOSEST_THREADS, CLOSEST_WIDE_MIN;
cuda_restir.RIS_SMEM_LIGHTS; cuda_image.ATROUS_TILE,
ATROUS_HALO), which the CPU models of the kernels, the tests' table sizes
and chip_smoke.py's counts read, equal the constants of csrc/trace.cu,
csrc/restir.cu and csrc/atrous.cu, and cuda_build refuses a library whose
shape queries report another shape. The launch helpers that the
before/after tools call with another build's library (K13, K14, K2, K1,
K3, K5, K7) count a launch of the port's own library and no other."""

import re

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread, as every port test)
from sunray_tpu_torch.ops import (cuda_build, cuda_history, cuda_image,
                                  cuda_restir, cuda_trace)

SHAPES = {
    "sunray_woop_launch_shape": (
        "trace.cu", ("kWoopRays", "kWoopThreads"),
        (cuda_trace.WOOP_RAYS, cuda_trace.WOOP_THREADS)),
    "sunray_occluded_launch_shape": (
        "trace.cu", ("kOccRays", "kOccThreads", "kOccWideMin"),
        (cuda_trace.OCC_RAYS, cuda_trace.OCC_THREADS, cuda_trace.OCC_WIDE_MIN)),
    "sunray_closest_launch_shape": (
        "trace.cu", ("kCloseRays", "kCloseThreads", "kCloseWideMin"),
        (cuda_trace.CLOSEST_RAYS, cuda_trace.CLOSEST_THREADS,
         cuda_trace.CLOSEST_WIDE_MIN)),
    "sunray_ris_launch_shape": (
        "restir.cu", ("kRisSmemLights",), (cuda_restir.RIS_SMEM_LIGHTS,)),
    "sunray_atrous_tile_shape": (
        "atrous.cu", ("kTileX", "kTileY", "kHalo"),
        (*cuda_image.ATROUS_TILE, cuda_image.ATROUS_HALO)),
}


@pytest.mark.parametrize("query", sorted(SHAPES))
def test_host_shape_is_the_sources(query):
    source, names, host = SHAPES[query]
    text = (cuda_build.CSRC_DIR / source).read_text()
    consts = tuple(int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
                   for n in names)
    assert consts == host
    # the query reports these constants, in this order
    body = re.search(rf"int {query}\(int\* out\) \{{(.*?)\}}", text, re.S).group(1)
    assert re.findall(r"out\[(\d)\] = (\w+);", body) == [
        (str(i), n) for i, n in enumerate(names)]


class _FakeLibrary:
    """Shape queries that report the given shapes."""

    def __init__(self, shapes):
        for name, shape in shapes.items():
            setattr(self, name, self._query(shape))

    @staticmethod
    def _query(shape):
        def fill(out):
            for i, v in enumerate(shape):
                out[i] = v
            return 0
        return fill


@pytest.mark.parametrize("off", [None, *sorted(SHAPES)])
def test_library_shape_is_checked(off):
    shapes = {q: host for q, (_, _, host) in SHAPES.items()}
    if off is not None:
        shapes[off] = (shapes[off][0] * 2, *shapes[off][1:])
    lib = _FakeLibrary(shapes)
    assert cuda_build.launch_shape(lib, "sunray_woop_launch_shape", 2) == \
        shapes["sunray_woop_launch_shape"]
    if off is None:
        cuda_build._check_launch_shapes(lib)
    else:
        with pytest.raises(cuda_build.KernelError, match=off):
            cuda_build._check_launch_shapes(lib)


class _FakeKernels:
    """Entry points that launch nothing and report no error."""

    def __getattr__(self, name):
        return lambda *args: 0


def _launch(name):
    """One launch by the helper behind wrapper `name`, from `lib`."""
    rays = torch.zeros((5, 3))
    img = torch.zeros((4, 6, 3))
    plane = torch.zeros((4, 6))
    return {
        "trace_occluded_woop": lambda lib: cuda_trace._launch_woop(
            torch.zeros((6, 2, 8)), torch.zeros((2, 1)), rays, rays, None,
            1e-4, None, 1.0, None, lib=lib),
        "atrous_pass": lambda lib: cuda_image._launch_pass(
            img, plane, img, plane, img, 1, torch.empty_like(img), lib=lib),
        "history_gather": lambda lib: cuda_history._launch_gather(
            [plane.reshape(-1)], torch.zeros((3,), dtype=torch.int64), lib=lib),
        "trace_closest": lambda lib: cuda_trace._launch_closest(
            (rays, rays, rays), rays, rays, None, 1e-4, None, 1e30, lib=lib),
        "di_spatial": lambda lib: cuda_restir._launch_di_spatial(
            cuda_restir.LightTable(*(torch.zeros((2, 3)),) * 4),
            torch.zeros((6,), dtype=torch.int64),
            dict(light_pos=torch.zeros((6, 3)), light_normal=torch.zeros((6, 3)),
                 W=torch.zeros((6,)), M=torch.zeros((6,)),
                 light_idx=torch.zeros((6,), dtype=torch.int32)),
            [(1, 0)], torch.ones((6,), dtype=torch.bool), torch.zeros((6, 3)),
            torch.zeros((6,)), torch.zeros((6,)), torch.zeros((6, 3)),
            torch.zeros((6, 3)), torch.zeros((6, 3)), torch.zeros((6, 3)),
            torch.zeros((6,)), torch.zeros((6,)), 3, 2, (1.0, 2.0, 3.0),
            lib=lib),
        "trace_occluded": lambda lib: cuda_trace._launch_occluded(
            (rays, rays, rays), rays, rays, None, 1e-4, None, 1.0, None,
            lib=lib),
        "ris_audition": lambda lib: cuda_restir._launch_audition(
            cuda_restir.LightTable(*(torch.zeros((2, 3)),) * 4),
            torch.zeros((5,), dtype=torch.int64), rays, rays, rays, rays,
            torch.zeros((5,)), torch.zeros((5,)), 16,
            torch.ones((5,), dtype=torch.bool), lib=lib),
    }[name]


@pytest.mark.parametrize("name", ["atrous_pass", "di_spatial",
                                  "history_gather", "ris_audition",
                                  "trace_closest", "trace_occluded",
                                  "trace_occluded_woop"])
def test_launch_helpers_count_the_ports_library_only(name, monkeypatch):
    own = _FakeKernels()
    monkeypatch.setattr(cuda_build, "library", lambda: own)
    monkeypatch.setattr(cuda_build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(cuda_build, "launches", cuda_build.launches.copy())
    cuda_build.launches.clear()
    launch = _launch(name)
    launch(None)
    assert cuda_build.launches == {name: 1}
    launch(_FakeKernels())          # another build's library
    assert cuda_build.launches == {name: 1}
