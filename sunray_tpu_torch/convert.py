"""Carry scenes, frame state, camera matrices, texture atlases, cluster
sets, BVHs and BLAS sets into the port from numpy.

Each function takes a dict of numpy arrays keyed by the field names that
the JAX package's dataclasses use (nested dicts for the nested ones), so
a test can hand both packages the identical scene, state and matrices.
Nothing here imports JAX: the caller turns its arrays into numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from sunray_tpu_torch.ops.binned_trace import ClusterSet, cluster_set
from sunray_tpu_torch.ops.bvh import Bvh
from sunray_tpu_torch.ops.bvh2 import BlasSet
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


def atlas_from_numpy(fields: dict, device="cuda") -> TextureAtlas:
    """TextureAtlas from its fields (data, size, wrap, filt)."""
    return _build(TextureAtlas, fields, device)


def bvh_from_numpy(fields: dict, device="cuda") -> Bvh:
    """Bvh from the JAX package's fields; num_leaves is a plain int."""
    f = dict(fields)
    nl = int(np.asarray(f.pop("num_leaves")))
    return Bvh(**{k: _t(v, device) for k, v in f.items()}, num_leaves=nl)


def blas_set_from_numpy(fields: dict, device="cuda") -> BlasSet:
    """BlasSet from the JAX package's fields. Its float32 node rows carry
    the children's ids and instance codes bitcast in columns 0-3 and its
    leaf rows the triangle ids bitcast in every tenth word; the port
    keeps them as int32 planes."""
    k = int(np.asarray(fields["leaf_k"]))
    node = np.ascontiguousarray(np.asarray(fields["node_pack"], np.float32))
    leaf = np.ascontiguousarray(np.asarray(fields["leaf_pack"], np.float32))
    leaf = leaf.reshape(leaf.shape[0], k, 10)
    return BlasSet(
        node_ids=_t(np.ascontiguousarray(node[:, :4]).view(np.int32), device),
        node_box=_t(node[:, 4:], device),
        leaf_v=_t(leaf[..., :9], device),
        leaf_ids=_t(np.ascontiguousarray(leaf[..., 9]).view(np.int32), device),
        prim_root=_t(np.asarray(fields["prim_root"], np.int32), device),
        prim_root_min=_t(fields["prim_root_min"], device),
        prim_root_max=_t(fields["prim_root_max"], device),
        prim_tri_count=_t(np.asarray(fields["prim_tri_count"], np.int32),
                          device),
        leaf_k=k, n_leaf_rows=int(np.asarray(fields["n_leaf_rows"])),
        n_blas_int=int(np.asarray(fields["n_blas_int"])))
