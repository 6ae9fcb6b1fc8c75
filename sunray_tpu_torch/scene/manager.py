"""Keyed scene management: runtime mesh add/remove + per-frame instances —
port of sunray_tpu/scene/manager.py.

The ResourceManager<K> analog (resource_manager.rs:41-80): meshes
("primitives", the BLAS analog) are registered under caller-chosen keys;
the caller owns the per-frame instance list (lib.rs:794,984 contract) and
hands `(key, transform)` pairs to each frame.

The packed triangle and instance arrays are padded to power-of-two
capacities (the reference's arena capacities, resource_manager.rs:14), as
the JAX package pads them to keep its compiled frame program: the port
keeps the same shapes, so both packages trace the same triangle lists.
Degenerate padding triangles (zero area at the origin) can never be hit
and cost one leaf in the LBVH.

Transform-only updates (animation) never touch topology: they rewrite
`inst_transform` in place, and the Renderer's AsState heuristic
(ops/accel_state.py) picks refit vs rebuild for the BVH.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sunray_tpu_torch.scene.types import (
    MaterialTable,
    SceneBuffers,
    TextureAtlas,
    build_scene,
)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


class MeshRecord:
    def __init__(self, positions, normals, tri_vidx, material,
                 tangents=None, uvs=None):
        self.positions = np.asarray(positions, np.float32)
        self.normals = np.asarray(normals, np.float32)
        self.tri_vidx = np.asarray(tri_vidx, np.int32)
        self.material = dict(material)
        self.tangents = tangents
        self.uvs = uvs


class SceneManager:
    """Mutable host-side scene; emits SceneBuffers on `device`."""

    def __init__(self, textures: Optional[TextureAtlas] = None,
                 device="cuda"):
        self.device = device
        self._meshes: Dict[Hashable, MeshRecord] = {}
        self._textures = textures
        self._generation = 0
        # Capacity high-water marks (see build's ratchet).
        self._tri_cap = 0
        self._inst_cap = 0

    # -- mesh registry (load_mesh/unload_mesh analog, lib.rs:873-973) --
    def add_mesh(self, key: Hashable, positions, normals, tri_vidx,
                 material: dict, tangents=None, uvs=None) -> None:
        if key in self._meshes:
            raise KeyError(f"mesh key {key!r} already registered")
        self._meshes[key] = MeshRecord(
            positions, normals, tri_vidx, material, tangents, uvs
        )
        self._generation += 1

    def remove_mesh(self, key: Hashable) -> None:
        del self._meshes[key]
        self._generation += 1

    def has_mesh(self, key: Hashable) -> bool:
        return key in self._meshes

    @staticmethod
    def from_scene_buffers(scene: SceneBuffers) -> "SceneManager":
        """Adopt a loaded scene (e.g. from load_gltf) mesh-by-mesh."""
        mgr = SceneManager(textures=scene.textures,
                           device=scene.positions.device)
        pos, nrm, tan, uvs, tv, t_inst, inst_prim = (
            x.detach().cpu().numpy() for x in (
                scene.positions, scene.normals, scene.tangents, scene.uvs,
                scene.tri_vidx, scene.tri_inst, scene.inst_prim))
        mats = _host(scene.materials)
        n_prims = int(mats["base_color"].shape[0])
        for pid in range(n_prims):
            insts = np.nonzero(inst_prim == pid)[0]
            if insts.size == 0:
                continue
            mask = t_inst == insts[0]
            tris = tv[mask]
            vids = np.unique(tris)
            remap = np.full(pos.shape[0], -1, np.int64)
            remap[vids] = np.arange(vids.size)
            mgr.add_mesh(
                key=f"prim{pid}",
                positions=pos[vids],
                normals=nrm[vids],
                tri_vidx=remap[tris],
                material={
                    "base_color": mats["base_color"][pid],
                    "metallic": float(mats["metallic"][pid]),
                    "roughness": float(mats["roughness"][pid]),
                    "emissive_factor": mats["emissive_factor"][pid],
                    "alpha_mode": int(mats["alpha_mode"][pid]),
                    "alpha_cutoff": float(mats["alpha_cutoff"][pid]),
                    "transmission": float(mats["transmission"][pid]),
                    "ior": float(mats["ior"][pid]),
                    "tex_index": mats["tex_index"][pid],
                },
                tangents=tan[vids],
                uvs=uvs[vids],
            )
        return mgr

    def default_instances(self, scene: SceneBuffers) -> List[Tuple[Hashable, np.ndarray]]:
        """Instance list reproducing a loaded scene's placements."""
        inst_prim = scene.inst_prim.cpu().numpy()
        xf = scene.inst_transform.detach().cpu().numpy()
        return [
            (f"prim{int(p)}", xf[i]) for i, p in enumerate(inst_prim)
        ]

    # -- frame assembly --
    def build(self, instances: Sequence[Tuple[Hashable, np.ndarray]],
              pad_to_capacity: bool = True) -> SceneBuffers:
        """Assemble SceneBuffers for the given caller-owned instance list.

        instances: [(mesh key, (3,4) object->world transform), ...]
        """
        keys = sorted(self._meshes.keys(), key=repr)
        key_to_pid = {k: i for i, k in enumerate(keys)}

        positions, normals, tangents, uvs = [], [], [], []
        tri_vidx, prim_of_tri = [], []
        voff = 0
        mat_records = []
        for k in keys:
            m = self._meshes[k]
            nverts = m.positions.shape[0]
            positions.append(m.positions)
            normals.append(m.normals)
            tangents.append(
                m.tangents if m.tangents is not None
                else np.zeros((nverts, 4), np.float32)
            )
            uvs.append(
                m.uvs if m.uvs is not None
                else np.zeros((nverts, 5, 2), np.float32)
            )
            tri_vidx.append(m.tri_vidx + voff)
            prim_of_tri.append(
                np.full(m.tri_vidx.shape[0], key_to_pid[k], np.int32)
            )
            mat_records.append(m.material)
            voff += nverts

        inst = [(key_to_pid[k], np.asarray(t, np.float32)) for k, t in instances]

        scene = build_scene(
            positions=np.concatenate(positions) if positions else np.zeros((0, 3), np.float32),
            normals=np.concatenate(normals) if normals else np.zeros((0, 3), np.float32),
            tri_vidx=np.concatenate(tri_vidx).astype(np.int32) if tri_vidx else np.zeros((0, 3), np.int32),
            prim_of_tri=np.concatenate(prim_of_tri) if prim_of_tri else np.zeros((0,), np.int32),
            materials=MaterialTable.build(mat_records or [{}],
                                          device=self.device),
            instances=inst,
            tangents=np.concatenate(tangents) if tangents else None,
            uvs=np.concatenate(uvs) if uvs else None,
            textures=self._textures,
            device=self.device,
        )
        if pad_to_capacity:
            # Capacity RATCHET: pad up to the largest capacity this
            # manager has ever built, so every despawn/respawn below the
            # high-water mark keeps the shapes (the reference's arena
            # never shrinks either).
            scene = pad_scene_capacity(scene, self._tri_cap, self._inst_cap)
            self._tri_cap = max(self._tri_cap, int(scene.num_tris))
            self._inst_cap = max(self._inst_cap,
                                 int(scene.inst_prim.shape[0]))
        return scene


def pad_scene_capacity(scene: SceneBuffers, min_tris: int = 0,
                       min_inst: int = 0) -> SceneBuffers:
    """Pad the world-triangle AND instance arrays to power-of-two
    capacities (at least min_tris/min_inst) so small topology edits keep
    array shapes stable: the arena-capacity analog. Padded triangles are degenerate (all corners at
    vertex 0 of instance 0); padded instances carry prim 0 with a ZERO
    transform and are referenced by no triangle (the light tables were
    built from the real instances before padding, so padding can never add
    lights)."""
    t = scene.num_tris
    dev = scene.tri_vidx.device
    cap = max(_next_pow2(max(t, 1)), min_tris)
    if cap != t:
        pad = cap - t
        scene = dataclasses.replace(
            scene,
            tri_vidx=torch.cat([scene.tri_vidx, torch.zeros(
                (pad, 3), dtype=torch.int32, device=dev)]),
            tri_inst=torch.cat([scene.tri_inst, torch.zeros(
                (pad,), dtype=torch.int32, device=dev)]),
        )
    ni = scene.inst_prim.shape[0]
    icap = max(_next_pow2(max(ni, 1)), min_inst)
    if icap != ni:
        ipad = icap - ni
        scene = dataclasses.replace(
            scene,
            inst_prim=torch.cat([scene.inst_prim, torch.zeros(
                (ipad,), dtype=torch.int32, device=dev)]),
            inst_transform=torch.cat([scene.inst_transform, torch.zeros(
                (ipad, 3, 4), dtype=torch.float32, device=dev)]),
        )
    return scene


def _host(mats) -> dict:
    """numpy copies of a MaterialTable's fields."""
    return {f.name: getattr(mats, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(mats)}
