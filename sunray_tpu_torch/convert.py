"""Carry scenes, frame state and camera matrices into the port from numpy.

Each function takes a dict of numpy arrays keyed by the field names that
the JAX package's dataclasses use (nested dicts for the nested ones), so
a test can hand both packages the identical scene, state and matrices.
Nothing here imports JAX: the caller turns its arrays into numpy.
"""

from __future__ import annotations

import numpy as np
import torch

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


def scene_from_numpy(fields: dict, device="cpu") -> SceneBuffers:
    """SceneBuffers from numpy arrays; fields["materials"] and
    fields["textures"] are dicts of MaterialTable / TextureAtlas fields."""
    return _build(SceneBuffers, fields, device, nested={
        "materials": lambda d, dev: _build(MaterialTable, d, dev),
        "textures": lambda d, dev: _build(TextureAtlas, d, dev),
    })


def state_from_numpy(fields: dict, device="cpu") -> RenderState:
    """RenderState from numpy arrays; fields["res_di"] and fields["res_gi"]
    are dicts of reservoir fields."""
    return _build(RenderState, fields, device, nested={
        "res_di": lambda d, dev: _build(restir.ReservoirDI, d, dev),
        "res_gi": lambda d, dev: _build(restir.ReservoirGI, d, dev),
    })


def mats_from_numpy(mats: dict, device="cpu") -> dict:
    """Camera matrices dict (view_inverse, proj_inverse, view_proj)."""
    return {k: _t(np.asarray(v, np.float32), device) for k, v in mats.items()}
