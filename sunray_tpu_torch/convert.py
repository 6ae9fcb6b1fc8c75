"""Carry scenes, frame state, camera matrices and cluster sets into the port
from numpy.

Each function takes a dict of numpy arrays keyed by the field names that
the JAX package's dataclasses use (nested dicts for the nested ones), so
a test can hand both packages the identical scene, state and matrices.
Nothing here imports JAX: the caller turns its arrays into numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from sunray_tpu_torch.ops.binned_trace import ClusterSet, cluster_set
from sunray_tpu_torch.render import restir
from sunray_tpu_torch.render.pipeline import RenderState
from sunray_tpu_torch.scene.types import MaterialTable, SceneBuffers, TextureAtlas


def _t(x, device):
    return torch.from_numpy(np.array(x, order="C")).to(device)


def _build(cls, fields: dict, device, nested=None):
    nested = nested or {}
    kw = {}
    for name, value in fields.items():
        if name in nested:
            kw[name] = nested[name](value, device)
        elif value is None:
            kw[name] = None
        else:
            kw[name] = _t(value, device)
    return cls(**kw)


def scene_from_numpy(fields: dict, device="cuda") -> SceneBuffers:
    """SceneBuffers from numpy arrays; fields["materials"] and
    fields["textures"] are dicts of MaterialTable / TextureAtlas fields."""
    return _build(SceneBuffers, fields, device, nested={
        "materials": lambda d, dev: _build(MaterialTable, d, dev),
        "textures": lambda d, dev: _build(TextureAtlas, d, dev),
    })


def state_from_numpy(fields: dict, device="cuda") -> RenderState:
    """RenderState from numpy arrays; fields["res_di"] and fields["res_gi"]
    are dicts of reservoir fields. Live reservoirs carry over as they are;
    their ids (light_idx, sample_tri) become int32 planes."""
    ids = {"res_di": "light_idx", "res_gi": "sample_tri"}

    def reservoir(cls, name):
        def build(d, dev):
            return _build(cls, {k: (np.asarray(v, np.int32) if k == ids[name]
                                    else v) for k, v in d.items()}, dev)
        return build

    return _build(RenderState, fields, device, nested={
        "res_di": reservoir(restir.ReservoirDI, "res_di"),
        "res_gi": reservoir(restir.ReservoirGI, "res_gi"),
    })


def mats_from_numpy(mats: dict, device="cuda") -> dict:
    """Camera matrices dict (view_inverse, proj_inverse, view_proj)."""
    return {k: _t(np.asarray(v, np.float32), device) for k, v in mats.items()}


def cluster_set_from_numpy(fields: dict, device="cuda") -> ClusterSet:
    """ClusterSet from the JAX package's fields (tri_ids, tri_pack, aabb_lo,
    aabb_hi). Its float32 pack carries the ids bitcast in row 9; the port's
    pack is the same bits as int32 words."""
    pack = np.ascontiguousarray(np.asarray(fields["tri_pack"], np.float32))
    return cluster_set(
        tri_ids=_t(np.asarray(fields["tri_ids"], np.int32), device),
        tri_pack=_t(pack.view(np.int32), device),
        aabb_lo=_t(np.asarray(fields["aabb_lo"], np.float32), device),
        aabb_hi=_t(np.asarray(fields["aabb_hi"], np.float32), device),
    )
