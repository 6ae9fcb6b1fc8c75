"""Interactive-loop example on the PyTorch port (sunray_tpu_torch) — the
examples/window analog, port of examples/orbit.py; on the card unless
--cpu.

Renders an orbiting camera over the Cornell box at interactive cadence,
prints an FPS counter (window/main.rs:185-193), composites a stats overlay
onto each frame on the host (hud_overlay_np), and runs the scripted
runtime instance test: a duplicate mesh instance spawns at frame 24 and
despawns at frame 48 (window/main.rs:222-234 does this at frames
120/240). Frames are written as a PNG sequence (the swapchain-present
analog) with stats.json beside them.

With --inflight N each frame's LDR (u8 with --present u8) is copied into
a pinned host buffer without blocking, a CUDA event is recorded after the
copy, and the frame is presented N frames later, after waiting on its own
event: the card renders frames k+1..k+N while frame k is read back.

Usage: python examples/torch_orbit.py [--frames 72] [--size 320x240]
       [--out out/torch_orbit] [--inflight 2] [--present u8|f32]
       [--present-workers 1] [--scene cornell|PATH.glb] [--cpu]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass


import argparse
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sunray_tpu_torch.render.overlay2d import hud_overlay_np
from sunray_tpu_torch.utils.png import write_png

CHURN = (24, 48)    # spawn at the first frame, despawn at the second


def interior_orbit(scene):
    """(center, radius, eye height, fov) of the orbit INSIDE a glTF room,
    from host arrays (orbit.py:95-116): a third of the half-extent, looking
    across and slightly down into the room."""
    pos = scene.positions.detach().cpu().numpy()
    tv = scene.tri_vidx.cpu().numpy()
    ti = scene.tri_inst.cpu().numpy()
    xf = scene.inst_transform.detach().cpu().numpy()
    corners = pos[tv.reshape(-1)]
    xfc = xf[np.repeat(ti, 3)]
    world = np.einsum("nij,nj->ni", xfc[:, :, :3], corners) + xfc[:, :, 3]
    lo, hi = world.min(0), world.max(0)
    center = (lo + hi) / 2.0
    ext = hi - lo
    radius = 0.32 * float(min(ext[0], ext[2]))
    eye_h = float(lo[1] + 0.45 * ext[1])
    center = np.asarray([center[0], lo[1] + 0.30 * ext[1], center[2]])
    return center, radius, eye_h, 60.0, (lo, hi)


def orbit_camera(frame, frames, center, radius, eye_h, fov):
    """The orbit's camera at `frame` (orbit.py:247-255)."""
    from sunray_tpu_torch.camera import Camera

    angle = 2.0 * np.pi * frame / frames
    eye = (float(center[0]) + radius * np.sin(angle), eye_h,
           float(center[2]) + radius * np.cos(angle))
    return Camera(position=eye, target=tuple(float(c) for c in center),
                  fov_y=fov)


def frame_instances(frame, base_instances, smallest, churn=CHURN):
    """The instance list at `frame`: the base list, plus the smallest mesh
    moved down 0.8 for churn[0] <= frame < churn[1] (orbit.py:257-264)."""
    from sunray_tpu_torch.scene.types import translate

    instances = list(base_instances)
    if churn[0] <= frame < churn[1]:
        instances.append((smallest, translate(0.0, -0.8, 0.0)))
    return instances


def setup(w, h, scene="cornell", device="cuda"):
    """The Renderer with the scene's meshes in a SceneManager and its
    default instances (orbit.py:86-124). Returns (renderer, base
    instances, smallest mesh key, (center, radius, eye_h, fov))."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.renderer import Renderer
    from sunray_tpu_torch.scene import cornell_box
    from sunray_tpu_torch.scene.manager import SceneManager

    cfg = RenderConfig(width=w, height=h, lighting="restir")
    if scene == "cornell":
        buffers = cornell_box(device=device)
        orbit = (np.asarray([1.0, 1.0, 1.0]), 2.6, 1.3, 50.0)
    else:
        from sunray_tpu_torch.scene.gltf import load_gltf

        buffers = load_gltf(scene, device=device)
        center, radius, eye_h, fov, (lo, hi) = interior_orbit(buffers)
        orbit = (center, radius, eye_h, fov)
        print(f"scene {scene}: bounds {np.round(lo, 2)}..{np.round(hi, 2)}"
              f" interior orbit r={radius:.2f} eye_h={eye_h:.2f}",
              flush=True)
    r = Renderer(cfg, device=device)
    r._manager = SceneManager.from_scene_buffers(buffers)
    base_instances = r._manager.default_instances(buffers)
    r.scene = r._manager.build(base_instances)
    r._sync_scene_flags()
    smallest = min(
        base_instances,
        key=lambda kt: r._manager._meshes[kt[0]].tri_vidx.shape[0],
    )[0]
    return r, base_instances, smallest, orbit


def to_present(ldr, present):
    """The present format: u8 quantizes on the device (4x fewer bytes to
    read back), f32 is the raw LDR."""
    if present == "u8":
        return (torch.clamp(ldr, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return ldr


def start_readback(x):
    """(host tensor, event): x copied into a pinned host buffer without
    blocking and an event recorded after the copy; on the CPU, x itself
    and no event."""
    if x.device.type != "cuda":
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def host_image(host, event):
    """The frame as a float (H, W, 3) numpy array once its own copy is
    done."""
    if event is not None:
        event.synchronize()
    img = host.numpy().copy()
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img


def run(frames=72, size="320x240", out="out/torch_orbit", no_save=False,
        save_every=1, inflight=2, present="u8", present_workers=1,
        scene="cornell", device="cuda", churn=CHURN):
    """The loop of orbit.py:120-344, printing its lines and writing its
    PNGs and stats.json. churn: the spawn and despawn frames. Returns the
    stats dict."""
    w, h = (int(x) for x in size.split("x"))
    r, base_instances, smallest, orbit = setup(w, h, scene, device)
    center, radius, eye_h, fov = orbit
    os.makedirs(out, exist_ok=True)

    # Pre-warm: both instance lists once before the timed loop; the
    # SceneManager's capacity ratchet then pads the base list to the
    # spawn list's capacity, so the churn frames repack no larger scene.
    if scene == "cornell":
        from sunray_tpu_torch.camera import Camera

        warm_cam = Camera(position=(1.0, 1.3, 3.6), target=(1.0, 1.0, 1.0),
                          fov_y=50.0)
    else:  # frame 0's camera (orbit.py:141-145)
        warm_cam = orbit_camera(0, 1, center, radius, eye_h, fov)
    t0 = time.time()
    r.render(warm_cam, instances=frame_instances(churn[0], base_instances,
                                                 smallest, churn)).cpu()
    warm_ldr = r.render(warm_cam, instances=list(base_instances))
    to_present(warm_ldr, present).cpu()
    compile_s = time.time() - t0
    print(f"prewarm (both capacity programs): {compile_s:.1f} s", flush=True)
    r.reset_history()

    fps = 0.0
    frame_ms = []          # per-presented-frame walltime (FIFO order)
    churn_frames = []      # frames where the instance list changed
    pending = deque()      # in-flight (frame, host buffer, event) FIFO
    t_prev = time.time()

    def save(frame, img):
        if not no_save and frame % max(save_every, 1) == 0:
            write_png(os.path.join(out, f"frame_{frame:04d}.png"), img)
            return True
        return False

    def present_one(entry):
        """Blocking present: wait for the frame's own readback, HUD, PNG."""
        nonlocal fps, t_prev
        frame, host, event = entry
        img = host_image(host, event)
        hist = frame_ms[-60:] if len(frame_ms) >= 2 else None
        hud_overlay_np(img, [f"FPS {fps:6.2f}", f"FRAME {frame:04d}"],
                       frame_ms=hist)
        t_now = time.time()
        dt = t_now - t_prev
        inst_fps = 1.0 / max(dt, 1e-6)
        fps = inst_fps if fps == 0 else 0.9 * fps + 0.1 * inst_fps
        t_prev = t_now
        frame_ms.append(dt * 1e3)
        if save(frame, img):
            t_prev = time.time()  # PNG encode is host-side, not frame cost
        if frame % 12 == 0:
            print(f"frame {frame:4d}  fps {fps:6.2f}", flush=True)

    pool = None
    if present_workers > 1:
        # Parallel presents: each waits on its own frame's event, so the
        # readbacks of several frames overlap; steady stats come from
        # per-frame completion timestamps.
        pool = ThreadPoolExecutor(max_workers=present_workers)
        lock = threading.Lock()
        done_ts = {}
        last_done = [t_prev]
        futures = deque()

        def present_mt(entry):
            nonlocal fps
            frame, host, event = entry
            img = host_image(host, event)
            with lock:
                cur = fps
            hud_overlay_np(img, [f"FPS {cur:6.2f}", f"FRAME {frame:04d}"])
            t_now = time.time()
            with lock:
                done_ts[frame] = t_now
                dt = max(t_now - last_done[0], 1e-6)
                last_done[0] = t_now
                inst = 1.0 / dt
                fps = inst if fps == 0 else 0.9 * fps + 0.1 * inst
            save(frame, img)
            if frame % 12 == 0:
                print(f"frame {frame:4d}  fps {fps:6.2f}", flush=True)

    def dispatch(entry):
        if pool is None:
            present_one(entry)
            return
        futures.append(pool.submit(present_mt, entry))

    loop_t0 = time.time()
    try:
        for frame in range(frames):
            cam = orbit_camera(frame, frames, center, radius, eye_h, fov)
            instances = frame_instances(frame, base_instances, smallest,
                                        churn)
            if frame in churn:
                churn_frames.append(frame)
            ldr = to_present(r.render(cam, instances=instances), present)
            pending.append((frame, *start_readback(ldr)))
            if len(pending) > max(inflight, 0):
                dispatch(pending.popleft())
                # Bound the frames held by unfinished presents.
                while pool is not None and len(futures) > 2 * present_workers:
                    futures.popleft().result()
        while pending:
            dispatch(pending.popleft())
        if pool is not None:
            for f in futures:
                f.result()
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    if pool is not None:
        # Completion times -> per-frame intervals (monotonicized: pool
        # completions can land out of frame order).
        ts = np.maximum.accumulate(
            np.asarray([done_ts[f] for f in range(frames)]))
        frame_ms = list(np.diff(np.concatenate([[loop_t0], ts])) * 1e3)

    steady = frame_ms[1:]
    churn_ms = [frame_ms[f] for f in churn_frames]
    stats = {
        "scene": scene,
        "resolution": size,
        "frames": frames,
        "inflight": inflight,
        "present": present,
        "present_workers": present_workers,
        "device": (torch.cuda.get_device_name(r.device)
                   if r.device.type == "cuda" else "cpu"),
        "prewarm_s": round(compile_s, 1),
        # Loop start -> first present; with --inflight N it spans N + 1
        # frames.
        "first_present_ms": round(frame_ms[0], 1),
        "steady_mean_ms": round(float(np.mean(steady)), 1),
        "steady_p50_ms": round(float(np.median(steady)), 1),
        "steady_max_ms": round(float(np.max(steady)), 1),
        "steady_fps": round(1e3 / float(np.mean(steady)), 2),
        "churn_frames": churn_frames,
        "churn_frame_ms": [round(m, 1) for m in churn_ms],
        # The spawn and despawn frames within 3x the steady median,
        # floored at 1 s (orbit.py:324-333): a scene repack that grew the
        # capacity, or a rebuild, would show here.
        "no_recompile_on_churn": bool(
            all(m < max(3 * float(np.median(steady)), 1000.0)
                for m in churn_ms)
        ),
    }
    with open(os.path.join(out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats))
    print(f"wrote frames + stats.json to {out}/")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--out", default="out/torch_orbit")
    ap.add_argument("--no-save", action="store_true",
                    help="skip PNG writes (the render + overlay loop alone; "
                         "PNG encode is host-side and not part of the frame)")
    ap.add_argument("--save-every", type=int, default=1,
                    help="write every Nth frame")
    ap.add_argument("--inflight", type=int, default=2,
                    help="frames-in-flight depth: render N frames ahead of "
                         "the blocking present (the Vulkan frames-in-flight "
                         "analog, lib.rs MAX_FRAMES_IN_FLIGHT). 0 = fully "
                         "serial.")
    ap.add_argument("--present", choices=("u8", "f32"), default="u8",
                    help="present-readback format: u8 quantizes on the "
                         "device (4x fewer bytes) and converts back to float "
                         "on the host for the HUD; f32 reads the raw LDR")
    ap.add_argument("--present-workers", type=int, default=1,
                    help=">1 presents frames from a thread pool so the "
                         "blocking readbacks overlap; steady stats then come "
                         "from per-frame completion timestamps")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scene", default="cornell",
                    help="'cornell' (exterior orbit) or a .glb/.gltf path: "
                         "the camera then orbits INSIDE the room, exercising "
                         "the texture atlas, alpha and SceneManager paths in "
                         "the live loop")
    args = ap.parse_args(argv)
    return run(frames=args.frames, size=args.size, out=args.out,
               no_save=args.no_save, save_every=args.save_every,
               inflight=args.inflight, present=args.present,
               present_workers=args.present_workers, scene=args.scene,
               device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
