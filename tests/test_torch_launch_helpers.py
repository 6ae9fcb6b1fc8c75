"""The host side of the kernel launches, on the CPU with stand-in libraries.

K14's, K2's, K1's, K3's, K7's, B1's, K8's backward's and R1's launch
shapes:
the host's copies (cuda_trace.WOOP_RAYS, WOOP_THREADS, OCC_RAYS,
OCC_THREADS, OCC_WIDE_MIN, CLOSEST_RAYS, CLOSEST_THREADS,
CLOSEST_WIDE_MIN; cuda_restir.RIS_SMEM_LIGHTS; cuda_image.ATROUS_TILE,
ATROUS_HALO; cuda_boundary.LAUNCH_SHAPE; cuda_gather.BWD_LAUNCH_SHAPE,
RUN_SHAPE; cuda_bvh.LAUNCH_SHAPE; cuda_overlay.TILE, CHUNK),
which the CPU models of the kernels, the tests' table sizes and
chip_smoke.py's counts read, equal the constants of csrc/trace.cu,
csrc/restir.cu, csrc/atrous.cu, csrc/boundary.cu, csrc/gather.cu,
csrc/bvh.cu and csrc/overlay.cu, and
cuda_build refuses a library whose shape queries report another shape.
B1's K dispatch (every K of 1..MAX_K, nothing else); K8's backward's
launch shape as a pure function of (G * N, K,
C, SMs). The launch helpers that the before/after tools call with
another build's library (K13, K14, K2, K1, K3, K5, K7, B1, K8's
backward and its runs path, R1) count a launch of the port's own library and no other."""

import re

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread, as every port test)
from sunray_tpu_torch.ops import (cuda_boundary, cuda_build, cuda_bvh,
                                  cuda_gather, cuda_history, cuda_image,
                                  cuda_overlay, cuda_restir, cuda_trace)
from sunray_tpu_torch.render import overlay2d

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
    "sunray_boundary_launch_shape": (
        "boundary.cu", ("kThreads", "kLightGroup", "kMaxK", "kEdgeTile",
                        "kConstLights"),
        cuda_boundary.LAUNCH_SHAPE),
    "sunray_gather_bwd_launch_shape": (
        "gather.cu", ("kMaxRows", "kBwdMaxCols", "kBwdMaxWarps", "kBwdVec",
                      "kMaxGroups"),
        cuda_gather.BWD_LAUNCH_SHAPE),
    "sunray_bvh_launch_shape": (
        "bvh.cu", ("kThreads", "kStack", "kShared", "kTlasSmem"),
        cuda_bvh.LAUNCH_SHAPE),
    "sunray_gather_runs_launch_shape": (
        "gather.cu", ("kRunThreads", "kShortRun", "kRunCols", "kRunChunk",
                      "kSortThreads", "kSortItems", "kDigitBits",
                      "kMaxPasses"),
        cuda_gather.RUN_SHAPE),
    "sunray_overlay_launch_shape": (
        "overlay.cu", ("kTileX", "kTileY", "kChunk"),
        (*cuda_overlay.TILE, cuda_overlay.CHUNK)),
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
        "boundary_candidates": lambda lib: cuda_boundary._launch(
            rays, torch.ones((5,), dtype=torch.bool),
            torch.zeros((64, cuda_boundary.EDGE_WORDS)),
            torch.zeros((2, cuda_boundary.LIGHT_WORDS)), 8, lib=lib),
        "gather_rows_bwd": lambda lib: cuda_gather._launch_bwd(
            torch.zeros((3, 6, 8)), torch.zeros((3, 8), dtype=torch.int32),
            72, lib=lib),
        "gather_rows_bwd_runs": lambda lib: cuda_gather._launch_bwd_runs(
            torch.zeros((3, 4, 8)), torch.zeros((3, 8), dtype=torch.int32),
            600, lib=lib),
        "paint_meshes": lambda lib: cuda_overlay._launch_paint(
            img, cuda_overlay.pack_meshes(
                [overlay2d.tess_rect(1, 1, 3, 3, (1.0, 0.5, 0.0, 0.5))], 4, 6,
                "cpu"), lib=lib),
    }[name]


@pytest.mark.parametrize("name", ["atrous_pass", "boundary_candidates",
                                  "di_spatial", "gather_rows_bwd",
                                  "gather_rows_bwd_runs", "history_gather",
                                  "paint_meshes", "ris_audition",
                                  "trace_closest", "trace_occluded",
                                  "trace_occluded_woop"])
def test_launch_helpers_count_the_ports_library_only(name, monkeypatch):
    own = _FakeKernels()
    monkeypatch.setattr(cuda_build, "library", lambda: own)
    monkeypatch.setattr(cuda_build, "stream_ptr", lambda: 0)
    monkeypatch.setitem(cuda_gather._SMS, torch.device("cpu"), 132)
    monkeypatch.setattr(cuda_build, "launches", cuda_build.launches.copy())
    cuda_build.launches.clear()
    launch = _launch(name)
    launch(None)
    assert cuda_build.launches == {name: 1}
    launch(_FakeKernels())          # another build's library
    assert cuda_build.launches == {name: 1}


def test_runs_path_counts_each_launch(monkeypatch):
    monkeypatch.setattr(cuda_build, "library", lambda: _FakeKernels())
    monkeypatch.setattr(cuda_build, "stream_ptr", lambda: 0)
    monkeypatch.setitem(cuda_gather._SMS, torch.device("cpu"), 132)
    monkeypatch.setattr(cuda_build, "launches", cuda_build.launches.copy())
    cuda_build.launches.clear()
    for i in (1, 2):
        cuda_gather._launch_bwd_runs(torch.zeros((3, 4, 8)),
                                     torch.zeros((3, 8), dtype=torch.int32),
                                     600)
        assert cuda_build.launches == {"gather_rows_bwd_runs": i}


def test_b1_dispatches_every_k_it_is_built_for():
    for k in range(1, cuda_boundary.MAX_K + 1):
        assert cuda_boundary.kernel_k(k) == k
    for k in (0, -1, cuda_boundary.MAX_K + 1):
        with pytest.raises(cuda_build.KernelError, match="1 to"):
            cuda_boundary.kernel_k(k)
    # The source instantiates K = 1.. by recursion up to kMaxK and refuses
    # any other k before it launches.
    text = (cuda_build.CSRC_DIR / "boundary.cu").read_text()
    assert "launch_k<1>(k," in text and "if constexpr (K > kMaxK)" in text
    assert re.search(r"if \(k < 1 \|\| k > kMaxK", text)


@pytest.mark.parametrize("l_n,launches", [(0, 0), (1, 1), (2, 1), (1024, 1),
                                          (1025, 2), (3000, 3)])
def test_b1_launches_a_chunk_of_lights_at_a_time(l_n, launches):
    assert cuda_boundary.launches_for(l_n) == launches
    assert (launches - 1) * cuda_boundary.CONST_LIGHTS < max(l_n, 1) <= \
        max(launches, 1) * cuda_boundary.CONST_LIGHTS


BWD_CASES = [(3 * 921600, 72, 6), (921600, 4, 12), (921600, 36, 9),
             (8 * 921600, 64, 6), (3 * 2073600, 72, 6), (200003, 300, 11),
             (2 * 200003, 512, 6), (5, 1, 1), (0, 72, 6), (1000, 512, 16),
             (3 * 1000, 600 // 2, 40)]


@pytest.mark.parametrize("total,k,c", BWD_CASES)
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_bwd_launch_shape_covers_every_index_in_fixed_slices(total, k, c, sms):
    shape = cuda_gather.bwd_launch_shape(total, k, c, sms)
    assert shape == cuda_gather.bwd_launch_shape(total, k, c, sms)
    w = min(c, cuda_gather.MAX_COLS)
    assert shape["smem"] == shape["warps"] * 4 * (k + 32) * w
    assert 1 <= shape["warps"] <= cuda_gather.BWD_MAX_WARPS
    assert shape["smem"] <= cuda_gather.SMEM_BLOCK
    assert shape["warp_chunk"] % cuda_gather.BWD_STEP == 0
    assert shape["warp_chunk"] >= cuda_gather.BWD_STEP
    slots = shape["blocks"] * shape["warps"] * shape["warp_chunk"]
    assert slots >= total
    if total == 0:
        assert shape["blocks"] == 0
        return
    # No block without an index; at most BWD_BLOCKS_SM blocks an SM, each
    # within the SM's shared memory.
    assert (shape["blocks"] - 1) * shape["warps"] * shape["warp_chunk"] < total
    per_sm = -(-shape["blocks"] // sms)
    assert per_sm <= cuda_gather.BWD_BLOCKS_SM
    assert min(per_sm, cuda_gather.BWD_BLOCKS_SM) * (shape["smem"] + 1024) \
        <= cuda_gather.SMEM_SM or per_sm == 1
    g = shape["group_blocks"]
    assert shape["groups"] == -(-shape["blocks"] // g)
    assert shape["groups"] <= cuda_gather.BWD_MAX_GROUPS
    assert (g - 1) ** 2 < shape["blocks"] <= g * g


def test_bwd_launch_shape_of_the_steps_calls():
    # The 720p step's corner call: slices of 1,408 indices (11 steps) over
    # 264 blocks of 8 warps (2 an SM) leave 246 blocks with indices, in 16
    # groups of 16.
    assert cuda_gather.bwd_launch_shape(3 * 921600, 72, 6, 132) == dict(
        warps=8, blocks=246, warp_chunk=1408, group_blocks=16, groups=16,
        smem=19968)
    # The largest table: 6 warps of (512 + 32) x 16 floats, one block an SM.
    shape = cuda_gather.bwd_launch_shape(3 * 921600, 512, 16, 132)
    assert (shape["warps"], shape["blocks"], shape["smem"]) == (6, 129,
                                                                208896)
    for bad in ((100, 0, 6), (100, 513, 6), (100, 72, 0), (-1, 72, 6)):
        with pytest.raises(cuda_build.KernelError):
            cuda_gather.bwd_launch_shape(*bad, 132)


@pytest.mark.parametrize("n,offset,vec", [(8, 0, 4), (6, 0, 1), (8, 1, 1)])
def test_bwd_vec_needs_whole_aligned_vectors(n, offset, vec):
    ct = torch.zeros((2 * 3 * n + offset,))[offset:].reshape(2, 3, n)
    idx = torch.zeros((2, n), dtype=torch.int32)
    assert cuda_gather.bwd_vec(ct, idx) == vec
