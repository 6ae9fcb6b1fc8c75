"""PyTorch port, the padded box rule of K10's and K12's per-warp culls away
from the unit scene (ROADMAP Queue 3: the pad was held only at Cornell
scale).

The pad, 1e-4 (1 + |box| + |origin|) on every face (ops/cuda_binned.py
walk_boxes and lane_box_test), is meant to grow as Moller-Trumbore's
rounding grows with the coordinates in play. Held here on
tests/torch_big_scene.py's small scene scaled by 100 and by 1000 and
moved by 1000 along every axis: the eight ray families of
tests/torch_binned_cases.py are made in the unit scene and their origins
carried by the same map, and every (ray, cluster) pair with a hit that
tile_hits accepts, with t rounded as K10 rounds it and as K12 does, passes
lane_box_test at upper = t on the moved scene's own ClusterSet.
"""

import numpy as np
import pytest

from sunray_tpu_torch.ops import binned_trace as pbt
from torch_binned_cases import FAMILIES, K, cull_scene, family, unkept_hits
from torch_parity import t

MAPS = {"scale100": (100.0, 0.0), "scale1000": (1000.0, 0.0),
        "shift1000": (1.0, 1000.0)}


@pytest.fixture(scope="module")
def scene():
    """(unit-scene triangles, unit ClusterSet, {map: moved ClusterSet})."""
    tris, cs = cull_scene()
    moved = {name: pbt.build_cluster_set(
        tuple(t((v * s + b).astype(np.float32)) for v in tris), k=K)
        for name, (s, b) in MAPS.items()}
    return tris, cs, moved


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("where", sorted(MAPS))
def test_lane_box_test_keeps_every_hit_at_scale(scene, where, kind):
    tris, cs, moved = scene
    s, b = MAPS[where]
    o, d = family(kind, tris, cs)
    o = (o.astype(np.float64) * s + b).astype(np.float32)
    for pair in (False, True):
        bad, pairs = unkept_hits(moved[where], o, d, moved[where].walk_box,
                                 pair=pair)
        assert pairs > 1000
        assert not bad, (f"pair={pair}: {len(bad)} of {pairs} hits fail the "
                         f"box test: {bad[:4]}")
