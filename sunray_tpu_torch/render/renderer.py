"""Stateful Renderer facade — port of sunray_tpu/render/renderer.py.

The API twin of the reference's `Renderer` (src/lib.rs:84-198): it owns
the scene, config and cross-frame state, and exposes load_gltf /
load_scene / unload_scene, load_mesh / unload_mesh / set_instances,
render / render_to_host_memory / resize and the frame callbacks. Each
frame is one call of pipeline.render_frame on the scene's device (the
JAX package's jitted step has no counterpart: PyTorch runs eagerly).

The acceleration structure follows renderer.py:77-266: "auto" above the
brute limit picks the two-level tracer when two or more instances all
have BLASes within cfg.bvh2_blas_max_tris (load-time BlasSet, a TLAS a
frame), else the binned tracer (load-time ClusterSet); tracer="bvh"
drives the unified BVH through the AsState heuristic: SLOW_BUILD on the
host SAH builder for a fresh scene, FAST_BUILD (the device LBVH) on a
topology change, UPDATE (refit in the frame) on movement.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops.accel_state import FAST_BUILD, SLOW_BUILD, AsState
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.render.trace import brute_limit


class Renderer:
    def __init__(self, config: RenderConfig, scene=None, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        self.scene = scene
        self.state = RenderState.create(config, self.device)
        self._manager = None
        self._instances = None
        self._last_transforms = None   # host copy of the last upload
        self._accel = None
        self._accel_for = None
        # AS rebuild/refit heuristic (acceleration_structure/mod.rs:31-148)
        # and the op it chose for the last frame.
        self._as_state = AsState()
        self.last_accel_op = None
        self.last_aux = None    # the last frame's aux (render_frame)
        self._auto_mode = None
        self._auto_mode_for = None
        # Frame/resize callbacks (lib.rs:537-558): start/end callbacks run
        # once then drop (FnOnce); resize callbacks persist (FnMut).
        self._start_frame_cbs = []
        self._end_frame_cbs = []
        self._resize_cbs = []
        # Scene groups (lib.rs:779/849): load_gltf hands back a group id
        # that unload_scene() removes wholesale.
        self._groups = {}
        self._next_group = 0
        self.last_scene_group = None

    # -- callbacks (lib.rs:537-558) --
    def add_start_of_frame_callback(self, callback):
        """Run once at the start of the next render() (FnOnce semantics)."""
        self._start_frame_cbs.append(callback)

    def add_end_of_frame_callback(self, callback):
        """Run once after the next render(), receiving this Renderer."""
        self._end_frame_cbs.append(callback)

    def add_resize_callback(self, callback):
        """Run on every resize() with the new (width, height); persistent."""
        self._resize_cbs.append(callback)

    # -- acceleration structures (renderer.py:77-266) --
    def _scene_accel(self):
        """The accel this frame's tracer starts from: a ClusterSet, a
        BlasSet, a Bvh, or None (brute force, or an LBVH built in the
        frame by make_tracer)."""
        if self.scene is None:
            return None
        cfg = self.config
        if (cfg.tracer == "auto"
                and self.scene.num_tris > brute_limit(cfg, self.device)):
            mode = self._auto_big_mode()
        else:
            mode = cfg.tracer
        if mode == "binned":
            if not (isinstance(self._accel_for, tuple)
                    and self._accel_for[0] == "binned"
                    and self._accel_for[1] is self.scene):
                from sunray_tpu_torch.ops.binned_trace import build_cluster_set

                tris = self.scene.world_triangle_vertices()
                self._accel = build_cluster_set(tris, k=cfg.cluster_k)
                self._accel_for = ("binned", self.scene)
            return self._accel
        if mode == "bvh2":
            # The BLAS set depends on the mesh topology only, so it
            # survives transform-only updates (blas.rs static builds).
            from sunray_tpu_torch.ops.bvh2 import build_blas_set

            gen = (self._manager._generation if self._manager is not None
                   else id(self.scene))
            prims = tuple(np.unique(self.scene.inst_prim.cpu().numpy()))
            key = (gen, prims)
            if self._accel_for != ("bvh2", key):
                self._accel = build_blas_set(self.scene,
                                             leaf_size=cfg.bvh_leaf_size)
                self._accel_for = ("bvh2", key)
            return self._accel
        if mode != "bvh":
            self.last_accel_op = None
            return None
        return self._unified_accel()

    def _auto_big_mode(self) -> str:
        """"bvh2" when >= 2 instances all have small BLASes, else "binned"
        (renderer.py:145-169); cached per topology."""
        scene = self.scene
        gen = self._manager._generation if self._manager is not None else None
        key = (scene, gen, int(scene.num_tris))
        cached = self._auto_mode_for
        if (cached is not None and cached[0] is key[0]
                and cached[1:3] == key[1:]):
            return self._auto_mode
        tri_inst = scene.tri_inst.cpu().numpy()
        n_inst = int(scene.inst_prim.shape[0])
        largest = int(np.bincount(tri_inst, minlength=1).max())
        self._auto_mode = ("bvh2" if n_inst >= 2
                           and largest <= self.config.bvh2_blas_max_tris
                           else "binned")
        self._auto_mode_for = key
        return self._auto_mode

    def _unified_accel(self):
        """Unified world BVH under the AsState heuristic (renderer.py:
        171-255): a fresh scene -> SLOW_BUILD (host SAH); a spawn, despawn
        or mesh change -> FAST_BUILD (device LBVH); transform-only churn
        -> UPDATE (make_tracer refits the boxes every frame), at most 8
        between rebuilds; 16 quiet frames settle with a SLOW_BUILD."""
        scene = self.scene
        cfg = self.config
        if self._manager is not None:
            topo = ("mgr", self._manager._generation, int(scene.num_tris),
                    tuple(k for k, _ in (self._instances or [])))
            geom = b"".join(np.asarray(t, np.float32).tobytes()
                            for _, t in (self._instances or []))
        else:
            topo = ("obj", scene, int(scene.num_tris))
            geom = None
        have = isinstance(self._accel_for, tuple) and self._accel_for[0] == "bvh"
        prev_topo = self._accel_for[1] if have else None
        prev_geom = self._accel_for[2] if have else None

        def same_topo(a, b):
            if a is None or b is None or a[0] != b[0] or a[2:] != b[2:]:
                return False
            return a[1] is b[1] if a[0] == "obj" else a[1] == b[1]

        topology_changed = not same_topo(topo, prev_topo)
        geometry_changed = (not topology_changed) and geom != prev_geom
        if not have or (topology_changed and topo[0] == "obj"):
            op = SLOW_BUILD
            self._as_state = AsState()
        else:
            op = self._as_state.next_op(geometry_changed, topology_changed)

        if op == SLOW_BUILD:
            from sunray_tpu_torch.native import build_sah_bvh

            tris = [t.detach().cpu().numpy()
                    for t in scene.world_triangle_vertices()]
            self._accel = build_sah_bvh(*tris, leaf_size=cfg.bvh_leaf_size,
                                        device=self.device)
        elif op == FAST_BUILD:
            from sunray_tpu_torch.ops.bvh import build_bvh

            self._accel = build_bvh(scene.world_triangle_vertices(),
                                    leaf_size=cfg.bvh_leaf_size)
        # UPDATE / "none": keep the cached topology; make_tracer refits it.
        self._as_state.mark(op, topology_changed or geometry_changed)
        self._accel_for = ("bvh", topo, geom)
        self.last_accel_op = op
        return self._accel

    def _sync_scene_flags(self):
        """Alpha-mask traversal follows the scene (renderer.py:268-276)."""
        if self.scene is None:
            return
        want = bool(self.scene.has_alpha_mask)
        if want != self.config.alpha_mask_tracing:
            self.config = self.config.replace(alpha_mask_tracing=want)

    # -- scene management (lib.rs:779-857) --
    def load_scene(self, scene, reset_history: bool = True):
        self.scene = scene
        self._manager = None
        self._instances = None
        self._last_transforms = None
        self._groups = {}
        self.last_scene_group = None
        self._sync_scene_flags()
        if reset_history:
            self.reset_history()

    def load_gltf(self, path: str):
        """Load a glTF scene and return the caller-owned instance list
        (lib.rs:779-794); the scene group id for unload_scene() is
        `last_scene_group`."""
        from sunray_tpu_torch.scene.gltf import load_gltf
        from sunray_tpu_torch.scene.manager import SceneManager
        from sunray_tpu_torch.scene.types import merge_atlases

        scene = load_gltf(path, device=self.device)
        if self._manager is None:
            self._manager = SceneManager.from_scene_buffers(scene)
            keys = list(self._manager._meshes)
            self._instances = self._manager.default_instances(scene)
            tex0 = self._manager._textures
            tex_range = (0, 0 if tex0 is None else int(tex0.data.shape[0]))
        else:
            sub = SceneManager.from_scene_buffers(scene)
            atlas, off = merge_atlases(self._manager._textures, sub._textures)
            self._manager._textures = atlas
            tex_range = (off, 0 if sub._textures is None
                         else int(sub._textures.data.shape[0]))
            prefix = f"g{self._next_group}/"
            keys = []
            for key, mesh in sub._meshes.items():
                if off and "tex_index" in mesh.material:
                    ti = np.asarray(mesh.material["tex_index"])
                    mesh.material["tex_index"] = np.where(ti >= 0, ti + off, ti)
                self._manager._meshes[prefix + key] = mesh
                keys.append(prefix + key)
            self._manager._generation += 1
            self._instances = list(self._instances or []) + [
                (prefix + k, t) for k, t in sub.default_instances(scene)]
        group = self._next_group
        self._next_group += 1
        self._groups[group] = {"keys": keys, "tex": tex_range}
        self.last_scene_group = group
        self.scene = self._manager.build(self._instances)
        self._sync_scene_flags()
        self.reset_history()
        return list(self._instances)

    def unload_scene(self, group: int):
        """Remove every mesh (and its atlas textures) a load_gltf() call
        added (lib.rs:849-871); the remaining meshes' texture indices are
        remapped, so load/unload cycles do not grow the atlas."""
        if self._manager is None:
            raise KeyError(f"scene group {group} (no manager loaded)")
        rec = self._groups.pop(group)
        keys = set(rec["keys"])
        for k in keys:
            self._manager.remove_mesh(k)
        self._instances = [(k, t) for k, t in (self._instances or [])
                           if k not in keys]
        start, count = rec["tex"]
        if count:
            a = self._manager._textures
            n = a.data.shape[0]
            sel = torch.from_numpy(np.r_[0:start, start + count:n]).to(
                a.data.device)
            self._manager._textures = None if sel.numel() == 0 else type(a)(
                data=a.data[sel], size=a.size[sel], wrap=a.wrap[sel],
                filt=a.filt[sel])
            for mesh in self._manager._meshes.values():
                if "tex_index" in mesh.material:
                    ti = np.asarray(mesh.material["tex_index"])
                    mesh.material["tex_index"] = np.where(
                        ti >= start + count, ti - count, ti)
            for g in self._groups.values():
                s0, c0 = g["tex"]
                if s0 >= start + count:
                    g["tex"] = (s0 - count, c0)
        self._manager._generation += 1
        self.scene = self._manager.build(self._instances)
        self._sync_scene_flags()
        self.reset_history()

    # -- runtime mesh churn (lib.rs:873-973) --
    def load_mesh(self, key, positions, normals, tri_vidx, material,
                  tangents=None, uvs=None):
        from sunray_tpu_torch.scene.manager import SceneManager

        if self._manager is None:
            self._manager = SceneManager(device=self.device)
            self._instances = []
        self._manager.add_mesh(key, positions, normals, tri_vidx, material,
                               tangents, uvs)

    def unload_mesh(self, key):
        self._manager.remove_mesh(key)
        self._instances = [(k, t) for k, t in (self._instances or [])
                           if k != key]
        self.scene = self._manager.build(self._instances)

    def set_instances(self, instances):
        """Update the per-frame instance list [(mesh key, (3, 4)
        transform)]. The same keys as last frame: a transform-only update,
        only the (I, 3, 4) transforms are uploaded (lib.rs:1017-1116),
        kept at the padded instance capacity. Other keys re-pack the
        scene through the manager (renderer.py:394-446)."""
        instances = list(instances)
        prev = self._instances
        if (prev is not None and self.scene is not None
                and len(prev) == len(instances)
                and all(a == b for (a, _), (b, _) in zip(prev, instances))):
            new_t = np.stack([np.asarray(t, np.float32) for _, t in instances])
            self._instances = instances
            if self._last_transforms is None or not np.array_equal(
                    new_t, self._last_transforms):
                cap = int(self.scene.inst_transform.shape[0])
                up = new_t
                if cap > up.shape[0]:
                    up = np.concatenate([up, np.zeros(
                        (cap - up.shape[0], 3, 4), np.float32)])
                self.scene = dataclasses.replace(
                    self.scene, inst_transform=torch.from_numpy(up).to(
                        self.scene.inst_transform.device))
                self._last_transforms = new_t
            return
        self._instances = instances
        self.scene = self._manager.build(self._instances)
        self._last_transforms = (np.stack([np.asarray(t, np.float32)
                                           for _, t in instances])
                                 if instances else None)

    def reset_history(self):
        """Temporal-state reset (resize / scene-change, lib.rs:639)."""
        self.state = RenderState.create(self.config, self.device)

    def resize(self, width: int, height: int):
        """lib.rs:586-642: new size, temporal state reset."""
        self.config = self.config.with_size(width, height)
        self.reset_history()
        for cb in self._resize_cbs:
            cb((width, height))

    # -- rendering --
    def render(self, camera: Camera, instances=None):
        """One frame -> (H, W, 3) float32 LDR in [0, 1] on the device.
        Advances the state. instances: optional [(mesh key, transform)]
        for this frame (lib.rs:984)."""
        if self.scene is None and instances is None:
            raise RuntimeError("no scene loaded")
        cbs, self._start_frame_cbs = self._start_frame_cbs, []
        for cb in cbs:
            cb()
        if instances is not None:
            self.set_instances(instances)
        if self.scene is None:
            raise RuntimeError("no scene loaded")
        mats = camera_matrices(camera, self.config.width, self.config.height,
                               device=self.device)
        self.state, ldr, self.last_aux = render_frame(
            self.scene, self.config, self.state, mats, self._scene_accel())
        cbs, self._end_frame_cbs = self._end_frame_cbs, []
        for cb in cbs:
            cb(self)
        return ldr

    def render_to_host_memory(self, camera: Camera,
                              warmup: Optional[int] = None) -> np.ndarray:
        """Offline golden-image path (lib.rs:1908-1934): warm-up frames so
        ReSTIR and TAA have history, then (H, W, 4) RGBA8 on the host."""
        warmup = self.config.warmup_frames if warmup is None else warmup
        ldr = None
        for _ in range(warmup + 1):
            ldr = self.render(camera)
        img = ldr.detach().cpu().numpy()
        rgba = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        return (np.clip(rgba, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
