"""B1's walk (csrc/boundary.cu) modelled in PyTorch on the CPU, bit-equal
to its plain version (boundary_candidates_plain, a stable sort).

The kernel keeps only positive scores in its K slots: a slot starts at 0,
an edge enters on a strictly greater score than the last slot's, takes
the first slot whose score it exceeds and shifts the slots below it down
one. A lane with fewer than K live edges then fills its slots with the
edges of score 0 in index order, from edges 0..K-1 alone (at most `live`
of them scored), with the silhouette and face2 bits the walk kept for
them. The model takes those steps literally, edge by edge, for every K
the kernel is built for, on the Cornell box and the floating-box scene
at random points, and on a table of duplicated edges (equal positive
scores, ordered by edge index).
"""

import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread, as every port test)
from sunray_tpu_torch.ops import cuda_boundary
from sunray_tpu_torch.render import boundary, restir
from sunray_tpu_torch.scene import cornell_box
from sunray_tpu_torch.scene.procedural import _MeshBuilder
from torch_boundary_cases import floating_scene


def walk_model(xs, mask, edges, lights, k):
    """The kernel's selection, edge by edge: boundary_candidates_plain's
    (idx (L, K, P), n_live (L, P), sil (L, K, P), face2 (L, K, P))."""
    p, e_n = xs.shape[0], edges.shape[0]
    sil, f2 = cuda_boundary.silhouette(xs, edges)
    lanes = torch.arange(p)
    out = ([], [], [], [])
    for light in lights:
        score = cuda_boundary.candidate_score(xs, mask, edges, light)[0]
        best = torch.zeros((p, k))
        code = torch.zeros((p, k), dtype=torch.int64)
        live = torch.zeros((p,), dtype=torch.int64)
        pos = torch.zeros((p, k), dtype=torch.bool)
        for e in range(e_n):
            v = score[:, e]
            positive = v > 0.0
            live += positive
            if e < k:
                pos[:, e] = positive
            enter = positive & (v > best[:, k - 1])
            nb, nc = best.clone(), code.clone()
            for r in range(k - 1, 0, -1):
                up, here = v > best[:, r - 1], v > best[:, r]
                nb[:, r] = torch.where(up, best[:, r - 1],
                                       torch.where(here, v, best[:, r]))
                nc[:, r] = torch.where(up, code[:, r - 1],
                                       torch.where(here, e, code[:, r]))
            top = v > best[:, 0]
            nb[:, 0] = torch.where(top, v, best[:, 0])
            nc[:, 0] = torch.where(top, e, code[:, 0])
            best = torch.where(enter[:, None], nb, best)
            code = torch.where(enter[:, None], nc, code)
        kept = live.clamp(max=k)
        idx = torch.full((k, p), -1, dtype=torch.int64)
        s_out = torch.zeros((k, p), dtype=torch.bool)
        f_out = torch.zeros((k, p), dtype=torch.bool)
        for r in range(k):
            has = r < kept
            idx[r] = torch.where(has, code[:, r], -1)
            s_out[r] = has
            f_out[r] = has & f2[lanes, code[:, r]]
        r = kept.clone()
        for e in range(k):
            take = (r < k) & ~pos[:, e]
            rows = lanes[take]
            idx[r[take], rows] = e
            s_out[r[take], rows] = sil[rows, e]
            f_out[r[take], rows] = f2[rows, e]
            r += take
        assert (idx >= 0).all()
        for o, a in zip(out, (idx, live, s_out, f_out)):
            o.append(a)
    idx, n_live, s, f = (torch.stack(o) for o in out)
    return idx.to(torch.int32), n_live.to(torch.int32), s, f


def _tables(scene):
    scene = boundary.with_edge_topology(scene)
    lights = restir.Lights(scene)
    _, _, table, _, _ = boundary._edge_geometry(
        scene.world_triangle_vertices(), scene.edge_tri, scene.edge_k)
    return table, cuda_boundary.light_table(lights.v0, lights.v1, lights.v2)


@pytest.fixture(scope="module")
def cornell_tables():
    return _tables(cornell_box(device="cpu"))


def _points(p, seed):
    g = torch.Generator().manual_seed(seed)
    xs = torch.rand((p, 3), generator=g) * 2.2 - 0.1
    mask = torch.rand((p,), generator=g) > 0.1
    return xs, mask


def _assert_equal(got, want):
    for a, b, what in zip(got, want, ("idx", "n_live", "sil", "face2")):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what


@pytest.mark.parametrize("k", range(1, cuda_boundary.MAX_K + 1))
def test_walk_matches_plain_for_every_k(cornell_tables, k):
    table, lt = cornell_tables
    xs, mask = _points(1500, k)
    got = walk_model(xs, mask, table, lt, k)
    _assert_equal(got, cuda_boundary.boundary_candidates_plain(
        xs, mask, table, lt, k))
    assert int(got[1].max()) > 0


def test_walk_matches_plain_on_the_floating_scene():
    table, lt = _tables(floating_scene(_MeshBuilder).build(device="cpu"))
    xs, mask = _points(1500, 99)
    got = walk_model(xs, mask, table, lt, 8)
    _assert_equal(got, cuda_boundary.boundary_candidates_plain(
        xs, mask, table, lt, 8))
    assert int(got[1].max()) > 0


@pytest.mark.parametrize("k", [3, 8, 16])
def test_walk_orders_equal_scores_by_edge_index(cornell_tables, k):
    """Every edge twice: each positive score comes in equal pairs, and the
    live count reaches 8, so the ties fill the slots."""
    table, lt = cornell_tables
    twice = torch.cat([table, table]).contiguous()
    xs, mask = _points(1500, 7 + k)
    got = walk_model(xs, mask, twice, lt, k)
    _assert_equal(got, cuda_boundary.boundary_candidates_plain(
        xs, mask, twice, lt, k))
    assert int(got[1].max()) >= 8


def test_needed_ops_count_shared_work_once(cornell_tables):
    """chip_smoke.b1_needed_ops, B1's operations bound, against a count
    taken (pixel, edge) by (pixel, edge): the side tests once, each
    point's difference pt - x once for all the lights that test it, each
    light's projection tests up to the first point that passes, the score
    once if any light passes, cnum once a (pixel, light)."""
    import chip_smoke as cs
    from sunray_tpu_torch.ops import fp

    table, lt = cornell_tables
    xs, mask = _points(64, 5)
    sil, _ = cuda_boundary.silhouette(xs, table)
    want = lt.shape[0] * xs.shape[0] * cs.B1_CNUM_OPS
    shared = 0          # (pixel, edge) pairs that two lights both pass
    for p in range(xs.shape[0]):
        x = xs[p]
        for e in range(table.shape[0]):
            want += cs.B1_SIDE_OPS
            if not (bool(sil[p, e]) and bool(mask[p])):
                continue
            tested, passes = set(), 0
            for light in lt:
                cnum = fp.dot(light[0:3] - x, light[3:6])
                for i in range(3):
                    d = table[e, 3 * i:3 * i + 3] - x
                    tested.add(i)
                    den = fp.dot(d, light[3:6])
                    if not bool(den * cnum > 0.0):
                        want += cs.B1_HEAD_OPS
                        continue
                    t = cnum / (den if bool(den.abs() > cuda_boundary.DENOM_EPS)
                                else torch.tensor(cuda_boundary.DENOM_EPS))
                    if not bool(t > cuda_boundary.BEYOND):
                        want += cs.B1_BEYOND_OPS
                        continue
                    want += cs.B1_PROJECT_OPS
                    y = fp.fma(t, d, x)
                    if bool(((y > light[6:9]) & (y < light[9:12])).all()):
                        passes += 1
                        break
            want += cs.B1_DIFF_OPS * len(tested)
            want += cs.B1_SCORE_OPS * (passes > 0)
            shared += passes > 1
    assert shared > 0
    assert cs.b1_needed_ops(xs, mask, table, lt, step=16) == want
