#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (sunray_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in order; any failure raises and exits non-zero with no result:
  1. require a CUDA device; print the card's name and power limit
     (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader);
  2. build the kernels from csrc/ (nvcc, sm_90a); print K1's and K5's
     registers (-Xptxas=-v) and the warps they leave an SM; count the SASS
     instructions of K14's triangle loop, K7's tap path and staging loop,
     K3's candidate loop (a candidate), K2's and K1's triangle loops (a
     ray-triangle test) and K5's tap loop (a used tap) and the work around
     it (cuobjdump -sass, tools/sass.py) for their instruction-issue
     floors (four warp instructions an SM a cycle at the card's top SM
     clock);
  3. hold every kernel of the main path to its plain PyTorch version on
     the card at the main path's shapes, and time both (CUDA events,
     median of 10 runs):
       K1/K2 trace: 2,073,600 Cornell camera and bounce rays x 36 tris,
                    65,536 random rays x 4,096 random tris (K1 bit-equal
                    on t, tri, u, v and hit; K1 timed on the camera set,
                    its row's shape, and the random set); K2 (0 rays
                    differing) on 2,073,600 synthetic shadow rays, its
                    row's shape, and on the frames' own queries: the three
                    of frame 2 of the 1080p ReSTIR frame (4,147,200,
                    6,220,800 and 4,147,200 rays with their exclude ids)
                    and the first bounce round of frame 2 of the 1080p NEE
                    frame, each timed beside its bound, the tests its warp
                    rule runs and its issue floor; K1 (bit-equal) on the
                    frames' own closest-hit queries: the two of frame 2 of
                    the ReSTIR frame (camera, GI initial sample) and every
                    call of frame 2 of the NEE frame (10 of 2,073,600
                    rays), each timed beside its bound and issue floor;
       K8 gather:   the shade pass's three fetches: the 72x6 vertex
                    table at 3 x 2,073,600 indices, the 36x4 triangle
                    pack and the 4x12 material table at 2,073,600, with
                    out-of-range indices (each timed);
       K7 a-trous:  1080x1920, 4 passes, on synthetic guides and on the
                    guides the live 1080p ReSTIR frame passes to
                    atrous_denoise (frame 2), each with its bypass share;
       K3-K6 ReSTIR: the inputs each wrapper got in frame 2 of a 1080p
                    default ReSTIR render (live history; K3 with K=16 on
                    the box's 2 lights, K5 with 5 taps, K6 with 3), plus
                    K3 on 65,536 seeded lanes and a random 600-light
                    table (timed too), and K5 on frames 3-5's inputs too
                    (each timed; the shared taps move every frame). Seeds
                    bit-equal, M exact, winners agreeing on > 99.5% of
                    lanes, the rest to test_restir_math.py's tolerances;
                    K5's lanes differing from plain in any bit, each
                    tap's use, the warps whose lanes all keep the centre's
                    sample; K3's and K5's issue floors;
       K9, K13, K14 (the kernel switches): the inputs each wrapper got in
                    frame 3 of the 1080p switches frame (phase 7; the first
                    frame whose TAA reads history): K9 on its
                    raw, history and use mask (within 1e-6, bit-equality
                    printed), K13 on the joint DI+GI read and on the TAA
                    corners (bit-equal; its time, index_select's on the
                    packed (P, 29) table and the corners' in one run), K14
                    on every shadow query with its
                    exclude ids (>= 99.99% of rays, differing lanes printed)
                    and its tests run against the tests needed;
  4. render the golden configs (tests/test_golden.py:36-40, 96x64): NEE
     4 frames, ReSTIR 8 frames and ReSTIR with the kernel switches 4
     frames, on the card and on the CPU; PSNR > 40 dB between them and,
     for NEE and ReSTIR, against tests/goldens/cornell_{nee,restir}.npy;
     then the ReSTIR config with denoise_kernel "auto" (K7 once per pass)
     and "jnp" (no K7 launch), the two within PSNR > 40 dB;
  5. the main path: render_frame at 1920x1080 with the default config
     (lighting="restir"), Cornell camera (1,1,3.4) -> (1,1,0), fov 45; 5
     warm-up and 20 timed frames. The launch counters are zeroed just
     before and read just after; all eight kernels must have launched, and
     the rays per frame (the trace wrappers' batch sizes) must equal
     bench.py:7-13's count. Prints frame ms, Mray/s, peak device memory
     and the synced stage ms. Then the 1080p NEE frame, 2 warm-up and 5
     timed frames, with its own launch check of K1, K2, K7 and K8; K2's
     and K1's launches must be 7 times the calls captured in one NEE
     frame, K1's over the ReSTIR frames 25 times its two.
  6. the big-mesh slice (tests/torch_big_scene.py: the Cornell box with a
     mirror icosphere of 81,920 triangles, 81,956 in all, traced through a
     binned ClusterSet of 641 clusters, 161 superclusters):
       K10-K12 against their plain versions on the queries the tracer got
       in frame 2 of the 1080p big-mesh frame: the camera rays (K10
       closest), the GI bounce rays (K11, K12 closest, K10 closest on the
       overflow fallback) and the 3P GI taps' visibility rays with their
       exclude ids (K11, K12 any-hit, K10 any-hit on the fallback); rays
       agreeing on >= 99.99%, t/u/v within 1e-5, K11 bit-equal, K10 and
       the plain model of its walk (binned_round_warp) bit-equal on every
       live lane, K12 and its walk model (pair_round_warp) on every live
       pair lane; the overflow share; K10 timed on each of its three
       launches, with its bound and its cluster tests: needed, run by the
       warp rule (the model's count) and the old per-block items; K11
       timed on the GI bounce beside its non-FMA floor; K12 timed on both
       launches (GI bounce closest, GI-tap visibility any-hit), each with
       its needed cluster tests, the rule's and the unculled kernel's,
       and on the same launch with every lane dead;
       the small big-mesh config (subdiv 3, cluster_k 32, 48x32, 3
       frames) on the card and on the CPU, PSNR > 40 dB; the 1080p
       big-mesh frame with the default config, 5 warm-up and 20 timed
       frames, counters zeroed before: K3-K8 and K10-K12 must launch,
       rays per frame as bench.py counts them, ldr finite with mean in
       (0.05, 0.95), synced stage times and one profiled frame's device
       time by kernel, and K10's and K12's by launch; then one 480x270
       frame, binned against tracer="brute" (K1/K2 over all 81,956
       triangles), PSNR > 40 dB.
  7. the kernel-switches slice (cornell_restir_switches_1080p): the 1080p
     Cornell ReSTIR frame with taa_kernel="pallas",
     history_select_kernel="auto", history_joint_gather=True and
     trace_impl="woop"; 5 warm-up and 20 timed frames, counters zeroed
     before: K1, K3-K9, K13 and K14 must launch and K2 must not; rays per
     frame as bench.py counts them; ldr finite with mean in (0.05, 0.95);
     synced stage times; then 3 frames with history_select_kernel="auto"
     and 3 with "off" from a fresh state: ldr bit-equal (K13 only moves
     words).
  8. the differentiable slice (cornell_restir_fwdbwd_720p, the step that
     bench.py:128-190 times): the differentiable ReSTIR frame at the
     golden size on the card and on the CPU, 3 steps with the state
     threaded (losses within 1e-5 relative, gradients w.r.t. base_color
     and positions within rtol 1e-4 and a floor of 1e-5 of the largest
     entry, the positions gradient nonzero on the card); one 1280x720
     step (mean(ldr), gradients w.r.t. base_color and positions) with the
     counters zeroed before: K1, K2, K8 and K8's backward must launch,
     K3-K7, K9 and K13 must not (a differentiable frame runs their plain
     versions, as JAX's gates do); K8's backward against its plain
     version (index_add_) on that step's cotangents (vertex corners and
     material rows) and on 3 x 2,073,600 synthetic indices (over each
     row's sum of |ct|: within 1e-5 of the plain version's float64 sums
     and 1e-4 of its float32 ones; two runs bit-equal), timed on the
     step's first corner call beside index_add_ and its bound; the 720p step
     timed (3 warm-up, 5 timed, synced): ms, rays a step by
     bench.py:179-183's count and Mray/s, loss, gradient norms, peak
     memory, synced forward stages and backward; one 480x270 step with
     the stage checkpoints on and off (peak memory, time).
  9. the visibility gradients (the same step with both terms:
     edge_antialias=True, shadow_boundary_grads=True with its top-8
     candidates): the differentiable ReSTIR frame with both terms and the
     NEE frame with the dense term and edge antialiasing at the golden
     size, card vs CPU (3 steps, phase 8's bars); the 720p loss with edge
     antialiasing bit-equal with the shadow-boundary term on and off, the
     positions gradient apart; one 720p step with the counters zeroed
     before: K1, K2, K8, K8's backward and B1 (boundary_candidates) must
     launch, K3-K7, K9 and K13 must not; B1 against its plain version on
     that step's own calls (its first-rough hits) and on 921,600 random
     points, and on 65,536 of them at every K of 1..16 with that table
     and a random table of 600 edges (above one shared-memory tile), 0
     (light, pixel) lanes differing, timed beside its plain version and its bound (the
     operations its code runs on these inputs, the side tests once a
     (pixel, edge)); K8's backward on every call of that step (the
     visibility terms' three too, each timed beside its bound); the
     timed 720p step with both terms (3 warm-up, 5 timed,
     synced): ms, rays and Mray/s by bench.py's count, peak memory (limit
     40 GB), every gradient entry finite, synced stages; AD against
     central differences on tests/test_grads.py's two occluder-translation
     cases (NEE dense, 12 frames, eps 2e-2, rtol 0.20; ReSTIR K=8, 16
     frames, eps 1e-2, rtol 0.25; 64x48).
 10. a real scene through the Renderer (B2 and B3, csrc/bvh.cu): the
     seeded glTF of tools/synth_gltf.py (the reflection room, eight
     1024x1024 PNG textures, a 16-quad alpha-MASK panel grid, a 5,120-
     triangle icosphere instanced 50 times: 256,068 triangles), written
     under build/ and loaded with Renderer.load_gltf; each run the 1080p
     default ReSTIR frame, 3 warm-up and 6 timed frames (synced), the
     counters zeroed before: (a) tracer="auto" (the two-level tracer, B3
     must launch, B2, K1 and K2 must not), (b) tracer="bvh" (the host SAH
     build, B2), then 3 frames of set_instances animation (accel op
     "update" each) and a spawn ("fast_build"); each prints frame ms,
     Mray/s by bench.py's count (checked against the tracer's), ldr_mean,
     the accel op of every frame and the walk's launches a frame (at
     most the frame's trace queries: alpha cutout runs inside the walk,
     one launch a query); (c) on the frame's own queries (camera and
     GI-bounce closest hits, the first shadow query with exclude ids
     walked any-hit), the walk without alpha timed beside its bound (from
     its own per-ray test counters: slab tests x 27 + triangle tests x 53
     operations, or the rays' bytes) and its issue floor (the SASS of a
     pop of an internal node and of a triangle test, tools/sass.py, for
     the pops and tests it counted), and its plain twin
     (ops/bvh.walk_plain; all 2,073,600 camera lanes, 65,536 lanes spread
     over the others): tri, hit and the test counts bit-equal on every
     lane, t/u/v lanes differing counted; (d) every query of one frame
     as the frame runs it, the fused alpha walk: against the batch rounds
     over the walk kernel (render/trace.py's closest_alpha_rounds /
     occluded_alpha_rounds) on every lane, bit-equal, and against its
     plain twin (ops/bvh.walk_alpha_plain) on 65,536 lanes with the test
     counts equal; both routes timed; (e) the scene at 96x54 for 2 frames
     on the card and on the CPU port, PSNR > 40 dB. `python3
     tools/bvh_walk_run.py` runs phase 10 alone.
 11. differentiable real scenes (K8's backward above 512 rows, the runs
     path): (a) the small synthetic GLB (tests/torch_gltf_grad_cases.py)
     at 96x64, NEE and ReSTIR through "bvh" and "auto" (the two-level
     walk on both devices), gradients w.r.t. positions, base_color,
     inst_transform and the atlas on the card and on the CPU: losses
     within 1e-5, gradients within 1e-5 of their largest finite entry,
     NaN masks equal; (b) one 1280x720 step on phase 10's GLB
     ("auto", default ReSTIR, the four leaves) with the counters zeroed
     before: B3, K8 and K8's backward (both paths) must launch, K1, K2,
     B2, K3-K7, K9 and K13 must not; the runs path on that step's own
     calls above 512 rows (vertex corners, texels) and on one step's
     with edge antialiasing (the triangle table), against its plain
     version and the float64 sums (1e-5 of each row's sum of |ct|, NaN
     where they are NaN), two runs bit-equal, each kind timed beside
     its bound, index_add_, index_put_(accumulate=True), its own hand
     radix sort and torch.sort, and broken into its device launches by
     one torch.profiler session (every launch the port's kernels or a
     memset: no library sort); (c) the step timed (2 warm-up, 4 timed,
     synced) with its
     peak memory (limit 40 GB), launches a step and each gradient's NaN
     count; (d) one 720p differentiable step of the big mesh (binned)
     w.r.t. positions and base_color. `python3 tools/real_grads_run.py`
     runs phase 11 alone.
 12. the configurations, 1080p on the Cornell camera, each with the
     counters zeroed just before and read just after (2 warm-up, 3 timed
     frames): ReSTIR with samples=4 (K5 and K6 four launches a frame,
     K1 two), with per-pixel spatial taps (plain in both packages: K5
     and K6 idle), with bf16 shading (K3-K6's bf16 instantiations launch,
     the fp32 ones do not; each held to its plain version on frame 2's
     own inputs by the take-flip scheme and timed beside the fp32
     instantiation on the same data widened, its plain version and its
     bound with the attributes at 2 bytes), and cornell_box_many_lights(17)
     (578 lights; K3 on its table held to plain and timed); each config
     at the golden size card vs CPU (PSNR > 40 dB, 3 frames); the four
     quality cases of tests/test_torch_quality.py (128x72, 4 + 8 frames)
     against their converged truths under the ledger's bounds.
     Its summary is the line {"configs": ...} before the wall time.
 13. the tools of a benchmark and the last refusals of the frame: (a)
     phase 8's 720p step with shading_dtype="bf16" (launch check of one
     step: K1, K2, K8 and K8's backward launch, K3-K7, K9, K13 and
     K3-K6's bf16 instantiations do not; 2 warm-up, 3 timed steps, peak
     memory, beside phase 8's float32 step) and the step at 32x24 card
     vs CPU (2 steps, phase 8's bars, NaN masks equal); (b) the repo's
     two JPEGs decoded by utils/jpeg.py (seconds, the pixels' SHA-256
     against PIL's) and a tools/synth_gltf.py document textured with
     them through the Renderer, 96x64 card vs CPU (PSNR > 40 dB, 2
     frames); (c) ops/packing.py card vs CPU on 2M values, bit-equal;
     (d) the 1080p ReSTIR state after 3 frames saved and loaded
     (utils/checkpoint.py; seconds, MB), the next frame bit-equal from
     both; (e) utils/provenance.exec_paths of the default (phase 5),
     switches (phase 7), differentiable (phase 8), bf16 (phase 12),
     JPEG glTF and checkpoint frames against their launch counters: a
     "cuda" stage launched its kernel, a "plain" or "off" one none; (f)
     utils/profiling.stage_timings of the 1080p frame, one profiled frame
     summarised (top 10 device rows, idle share) and
     utils/roofline.roofline_report at phase 5's frame ms. Its summary
     is the line {"utilities": ...} after {"configs": ...}.
 14. the interactive path: (a) R1 (csrc/overlay.cu, the 2D overlay
     painter) against its plain twin on the card, bit-equal, on the 1080p
     HUD of hud_overlay (4 lines at scale 2, a 120-sample frame-time plot)
     and on a seeded stress set of 2,000 triangles over 4 meshes
     (tests/torch_overlay_cases.py: overlapping and degenerate triangles
     of both windings, a textured and a clipped mesh), each timed beside
     its bound, two runs of the stress set bit-equal to each other; on
     each adversarial set of tests/torch_overlay_cases.py at 1080p (thin,
     far and non-finite triangles, edges through pixel centres, meshes off
     the image, -0.0 image words, non-finite texels, negative colours, 40
     meshes), bit-equal; hud_overlay's wall time a call (host tessellation,
     packing, copies and launch) and paint_meshes' (packing, copies and
     launch) beside
     R1's device time; R1's launches read on hud_overlay over 3 rendered
     1080p frames; (b) utils/jpeg.write_jpeg on a rendered 1080p frame (ms at
     q85, read back by utils/jpeg.read_jpeg: PSNR) and the committed
     progressive JPEG (tests/data/progressive_96x64.jpg) decoded, its
     pixels' SHA-256 against PIL's; (c) integrations.LiveViewer at
     1920x1080, Cornell ReSTIR, on 127.0.0.1 port 0: 12 frames with a POST
     /input between, /frame.jpg decoding to the size, the camera moved,
     phase 5's kernels launched, frames a second and each frame's render /
     overlay / u8 copy / encode ms; (d) integrations.web_viewer.
     ViewerServer at 640x360: SPAWN through POST /input changes the
     instance count and the frame, PAUSE freezes the camera clock, frames a
     second. Its summary is the line {"viewers": ...} after
     {"utilities": ...}. `python3 tools/viewer_run.py` runs phase 14 alone.
 15. Multi-device rendering (parallel/), on the one card: (a) NCCL at
     world size 1 (a FileStore in a temporary directory): the row-sharded
     frame (parallel/spmd.py) on phase 5's 1080p Cornell ReSTIR frame for
     3 frames, bit-equal to render_frame from the same state, phase 5's
     kernels launched (K5 and K7 in their window form), frame ms beside
     phase 5's; (b) 4 gloo ranks sharing the card (torch.multiprocessing;
     a child's failure fails the script): the 1080p frame in 270-row
     bands (DI 30, GI 20, 4 a-trous passes, halo_t 16, history reads
     through K13, TAA through K9's window form), 3 static and 3
     slow-orbit frames gathered and held to the single-device frame at
     tests/test_spmd.py's bars (99.5% of pixels within 2e-5 static, 2e-4
     moving, all finite), K5, K7 and K9 in window form, K6 and K13
     launched on every rank and no whole-frame K5, K7 or K9, each rank's
     bytes a frame (traffic_tally) and host-staged exchange ms a frame
     (not a scaling figure: the ranks share one card); then
     sharding.render_frame_sharded on the (1, 4) mesh for 3 frames of
     fast motion (its history halo the whole image), held to the
     single-device frame at 2e-4, with its bytes a frame; (c)
     training_step at (dp, sp) = (2, 2) over the 4 ranks at 320x180 on
     the default ReSTIR config (TAA, 4 a-trous passes) and on the JAX
     dryrun's NEE config, loss and gradient within 1e-5 of the
     single-device step, with each rank's step ms and forward and
     backward halo bytes; (d) K5, K7 and K9 in window form and K6 on the
     1080p/4 band of frame 2's inputs (K9: frame 3's) against their
     plain twins (take-flip scheme; K7 1e-5; K9 bit-equal, and to the
     whole frame's K9 on the band), timed as phase 3 times them. Its
     summary is the line {"parallel": ...} after {"viewers": ...}.
     `python3 tools/parallel_run.py` runs phase 15 alone.
 16. The example programs (examples/torch_*.py), each through its
     run(...) on the card with stdout redirected: render_png (Cornell and
     room, 800x600, 16 warm-up frames), optimize_material (60 steps: max
     albedo error below 0.05), optimize_camera (80 steps: RECOVERED;
     --joint --edge-aa EX_JOINT_STEPS steps: the pose error falls), orbit
     (Cornell, 72 frames, churn at 24/48, in flight 2: no recompile on
     churn; its presented frames bit-equal to in flight 0 and to 2 present
     workers; phase 10's glTF, EX_GLTF_ORBIT_FRAMES frames), term_viewer
     (30 frames at 160x96, its summary line) and parity_report (phase 10's
     glTF at 1600x1200: the camera arm passing, the aux checks); every
     program's kernels launched (EX_KERNELS, the launch counters zeroed
     before it), no plain twin on the card (TwinSpy; the loops: the
     tracer's and K8's), every image finite; the loops' first 2 steps at
     24x18 card vs CPU (phase 8's bars). Its summary is the line
     {"examples": ...} after {"parallel": ...}; then {"phase_seconds":
     ...}, each phase's wall seconds. `python3 tools/examples_run.py`
     runs phase 16 alone.
The line before the last is {"kernels": [...]}: per kernel its launches
on its slice's main path, its error, kernel and library ms (CUDA events
around 10 calls enqueued behind a spin kernel, so run back to back, a
call; median of 3), plain ms (CUDA events around one call, median of 10;
K10's and K12's plain versions one call after their comparison's)
and its bound (the larger of bytes over 3.35 TB/s
and operations over 67 TFLOP/s fp32, from this run's inputs; a trace
counts the ray-triangle tests its rays need, e.g. K10 and K12 the
clusters whose box a ray enters before its closest hit, K2 and K14 the
tests up to each ray's first occluder, K7 24 taps of each pixel the
bypass does not copy); K1, K2, K3, K5, K7 and K14 also carry floor_ms,
their instruction-issue floor, K1 and K2 their live queries (live, one
entry each, their sum a ReSTIR frame and the NEE frame's launches), K1
and K5 their registers, K5 its frames 2-5. The line before it gives the
script's wall time. The last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_KW = dict(width=96, height=64, bounces=4, virtual_bounces=3,
                 ris_candidates=8, di_spatial_samples=3, gi_spatial_samples=2,
                 denoise_passes=2, lighting="nee")
GOLDEN_FRAMES = {"nee": 4, "restir": 8}     # tests/test_golden.py:18-19
CAMERA = dict(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
TRACE_AGREE = 0.9999      # tri / hit / occluded agreement on the card
UVT_ATOL = 1e-5           # t, u, v where tri agrees
ATROUS_ATOL = 1e-5
WINNER_AGREE = 0.995      # test_restir_math.py:209
PSNR_MIN = 40.0           # tests/test_golden.py:80
REPS = 10
HBM_BYTES_S = 3.35e12     # H100 SXM data sheet
FP32_OPS_S = 67e12
TEST_OPS = 53             # one Moller-Trumbore ray-triangle test, fp32 ops
SLAB_OPS = 27             # one ray-box slab test (K11)
BIG_SUBDIV = 6
# Timed calls of K10's and K12's plain versions (1.7-9.3 s each at 1080p),
# after the comparison's call: 10 after 2 warm-ups (3 on the fallbacks and
# K12's any-hit) before phase 16 joined the script.
BINNED_PLAIN_REPS = 1
SMALL_BIG = dict(GOLDEN_KW, lighting="restir", width=48, height=32,
                 cluster_k=32)
SMALL_BIG_SUBDIV, SMALL_BIG_FRAMES = 3, 3
# The kernel-switches slice (phase 7) and its golden-size config (phase 4).
SWITCHES = dict(taa_kernel="pallas", history_select_kernel="auto",
                history_joint_gather=True, trace_impl="woop")
SWITCH_FRAMES = 4
TAA_ATOL = 1e-6
# One Woop test in csrc/trace.cu's woop_hit, an fmaf counted as two: 33 for
# the six dot products, 22 for the epilogue's products, compares, selects.
WOOP_OPS = 55
# One a-trous tap in csrc/atrous.cu, fp32 operations (a division, sqrtf and
# expf counted as one each): the neighbour's diffuse difference and norm,
# luma ratio, normal dot, power, weight, and the four sums.
ATROUS_TAP_OPS = 40
# Phase 8, the differentiable slice (cornell_restir_fwdbwd_720p).
DIFF_SIZE = (1280, 720)
DIFF_OFF_SIZE = (480, 270)          # the step with the checkpoints off
DIFF_STEPS = 3                      # card vs CPU, threaded state
DIFF_TIMED = 3                      # timed steps, phases 8-9 (10 before
                                    # phase 12 joined the script, 5
                                    # before phase 15 did)
DIFF_LOSS_RTOL = 1e-5
DIFF_GRAD_RTOL, DIFF_GRAD_FLOOR = 1e-4, 1e-5   # floor: of the largest |g|
# Phase 9, the visibility gradients (cornell_restir_fwdbwd_720p with both
# terms): the step of phase 8 with edge antialiasing and the
# shadow-boundary term on its top-8 candidates (tests/test_grads.py:360).
VIS_KW = dict(shadow_boundary_grads=True, shadow_boundary_candidates=8,
              edge_antialias=True)
VIS_PEAK_GB = 40.0                  # half the card (PERF.md section 2)
# B1's fp32 operations (csrc/boundary.cu; an fmaf counted as two, a
# compare, division or sqrtf as one): the two face-side tests of a
# (pixel, edge); the difference pt - x of an endpoint or the midpoint;
# one light's projection test of such a point, up to where it fails
# (heading, beyond the point, the box); the score's norm and division of
# a (pixel, edge); the cnum of a (pixel, light).
B1_SIDE_OPS = 18
B1_DIFF_OPS = 3
B1_HEAD_OPS, B1_BEYOND_OPS, B1_PROJECT_OPS = 7, 11, 23
B1_SCORE_OPS = 11
B1_CNUM_OPS = 8
# AD against central differences on the card: tests/test_grads.py's
# occluder-translation cases on the floating-box scene, at their sizes,
# frame counts, steps and tolerances.
FD_CAMERA = dict(position=(1.0, 1.7, 3.3), target=(1.0, 0.2, 0.7),
                 fov_y=45.0)
FD_SIZE = (64, 48)
FD_CASES = {
    "nee": (dict(lighting="nee"), 12, 2e-2, 0.20),
    "restir": (dict(lighting="restir", ris_candidates=8,
                    di_spatial_samples=2, gi_spatial_samples=1,
                    shadow_boundary_candidates=8), 16, 1e-2, 0.25),
}
# K8's backward, errors over each table row's sum of |ct|: against the
# plain version's float64 sums, below the first-order bound of the
# kernel's float32 sums (~130 adds on a row's longest chain at 720p: 44
# indices a lane, 32 lanes, 8 warps, 16 blocks a group, 16 groups;
# 7.7e-6); and
# against its float32 sums (index_add_'s float atomics in one running
# sum a row, 1.7e-5 off the float64 sums on the 720p step's cotangents).
K8_BWD_TOL = 1e-5
K8_BWD_PLAIN_TOL = 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=REPS, warm=2):
    """Median of `reps` CUDA-event timings of fn() after `warm` warm-ups:
    a plain version's time, its host work included."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_SPIN_CYCLES_PER_MS = []


def device_ms(fn, reps=REPS):
    """A kernel's or a library call's time on the card, a call: `reps`
    calls enqueued behind a spin kernel (torch.cuda._sleep) that outlasts
    their host work, with CUDA events around the calls alone; median of 3.
    The card runs them back to back, so no host time enters, where events
    around one call read the wrapper's host work when it is longer than
    the kernel."""
    if not _SPIN_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(10 ** 7 / start.elapsed_time(end))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(_SPIN_CYCLES_PER_MS[0] * (2.0 * host_ms + 1.0)))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(n_bytes, n_ops):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, n_ops / FP32_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def sass_counts(lib_path):
    """Count the inner loops' instructions in the built kernels' SASS
    (cuobjdump -sass) and read the card's SM count and top SM clock, for
    the instruction-issue floors. Returns {} where a count fails (the
    floors then print as not measured)."""
    from sunray_tpu_torch.ops import cuda_build
    from tools import sass

    try:
        cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                                 "cuobjdump")
        funcs = sass.functions(sass.disassemble(lib_path, cuobjdump))
        woop, _ = sass.loop_iteration(sass.find(funcs, "occluded_woop_kernel"),
                                      "LDS")
        atrous = sass.find(funcs, "atrous_kernel")
        taps, _ = sass.straight_after(atrous, "BAR.SYNC", "MUFU.EX2", 24)
        stage, _ = sass.loop_iteration(atrous, "STS")
        clock = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            check=True, timeout=60).stdout.split()[0])
    except (OSError, ValueError, KeyError, subprocess.SubprocessError) as e:
        log(f"  SASS counts: not measured ({type(e).__name__}: {e})")
        return {}
    out = dict(woop_loop=woop, atrous_taps=taps, atrous_stage=stage,
               clock_mhz=clock,
               n_sm=torch.cuda.get_device_properties(0).multi_processor_count)
    out.update(loop_unit_counts(funcs))
    out.update(di_spatial_counts(funcs))
    out.update(walk_counts(funcs))
    log(f"  SASS: K14 {woop} instructions a triangle iteration; K7 {taps} "
        f"from the staging barrier through 24 taps, {stage} a staging "
        f"iteration; {out['n_sm']} SMs at up to {clock:.0f} MHz")
    return out


# The multiplier of each PCG draw's output permutation (rnd, 277803737):
# one IMAD a draw, four draws a RIS candidate, one a DI spatial tap.
PCG_WORD_MUL = "0x108ef2d9"
# (key, kernel, the loop's body op, marker, markers a unit, the
# instructions an iteration passes, unit): K3's candidate loop
# (shared-memory table) through its target function's roots and
# reciprocals (MUFU), and K2's and K1's triangle loops, one IEEE
# reciprocal (MUFU.RCP) a ray-triangle test; each counted a unit of its
# work.
LOOP_UNITS = (
    ("k3_candidate", "ris_audition_kernelILb1E", "LDS",
     lambda ins: PCG_WORD_MUL in ins.text, 4,
     lambda ins: ins.op.startswith("MUFU"), "candidate"),
    ("k2_test", "15occluded_kernel", "LDS",
     lambda ins: ins.op.startswith("MUFU.RCP"), 1, lambda ins: False,
     "ray-triangle test"),
    ("k1_test", "14closest_kernel", "LDS",
     lambda ins: ins.op.startswith("MUFU.RCP"), 1, lambda ins: False,
     "ray-triangle test"),
)


def loop_unit_counts(funcs, keys=None):
    """{key: SASS instructions a unit} of the LOOP_UNITS loops (`keys`,
    default all) in `funcs` (sass.functions of a build), and {key}_units,
    the units an iteration; a count that fails is left out and printed as
    not measured."""
    from tools import sass

    out = {}
    for key, kernel, body, marker, per, through, unit in LOOP_UNITS:
        if keys is not None and key not in keys:
            continue
        # The fp32 instantiations (K3's bf16 one is timed, not counted).
        found = {name: code for name, code in funcs.items()
                 if kernel in name and "bfloat16" not in name}
        for name, code in found.items():
            try:
                count, units, _ = sass.loop_per_unit(code, body, marker, per,
                                                     through)
            except ValueError as e:
                log(f"  SASS {key} ({name}): not measured ({e})")
                continue
            # {key}_r{units}: each instantiation's count (K2 and K1 have one
            # for their wide launches and one for one ray a thread); {key}:
            # the widest.
            out[f"{key}_r{units:g}"] = count
            if units >= out.get(f"{key}_units", 0):
                out[key], out[f"{key}_units"] = count, units
            log(f"  SASS: {kernel} {count:.2f} instructions a {unit}, "
                f"{units:g} {unit}s an iteration of its loop")
        if not found:
            log(f"  SASS {key}: not measured (no function holds {kernel!r})")
    return out


def di_spatial_counts(funcs):
    """K5's SASS counts: {"k5_tap": a used tap's iteration of the tap loop
    (one PCG draw, through every MUFU of its target function),
    "k5_fixed": the path from entry to exit around the loop through every
    MUFU outside it (the centre merge, the resolve)}; {} where a count
    fails."""
    from tools import sass

    try:
        code = sass.find({name: code for name, code in funcs.items()
                          if "bfloat16" not in name}, "17di_spatial_kernel")
        tap, units, path = sass.loop_per_unit(
            code, "LDG", lambda ins: PCG_WORD_MUL in ins.text, 1,
            lambda ins: ins.op.startswith("MUFU"))
        index = {ins.addr: k for k, ins in enumerate(code)}
        fixed, _ = sass.around_loop(code, index[path[0].addr],
                                    index[path[-1].addr],
                                    lambda ins: ins.op.startswith("MUFU"))
    except (KeyError, ValueError) as e:
        log(f"  SASS K5: not measured ({e})")
        return {}
    log(f"  SASS: di_spatial_kernel {tap:.2f} instructions a used tap "
        f"({units:g} taps an iteration), {fixed} around the tap loop")
    return {"k5_tap": tap, "k5_fixed": fixed}


# B2's and B3's instantiations (csrc/bvh.cu's bvh_walk_kernel<any hit, two
# levels, alpha, stack word>) whose inner loops are counted: (key, name).
WALK_SASS = (("b2", "15bvh_walk_kernelILb0ELb0ELb0EjE"),
             ("b2_any", "15bvh_walk_kernelILb1ELb0ELb0EjE"),
             ("b3", "15bvh_walk_kernelILb0ELb1ELb0EjE"),
             ("b3_any", "15bvh_walk_kernelILb1ELb1ELb0EjE"),
             ("b2_alpha", "15bvh_walk_kernelILb0ELb0ELb1EjE"),
             ("b2_alpha_any", "15bvh_walk_kernelILb1ELb0ELb1EjE"),
             ("b3_alpha", "15bvh_walk_kernelILb0ELb1ELb1EjE"),
             ("b3_alpha_any", "15bvh_walk_kernelILb1ELb1ELb1EjE"))


def walk_counts(funcs, kernels=WALK_SASS):
    """{key_pop: SASS instructions of a pop of an internal node (the walk
    loop, the innermost loop holding FMNMX, through both slab tests' FMNMX
    and around the leaf's and the transform's work), key_tri: a triangle
    test (the innermost loop holding MUFU.RCP, the test's IEEE reciprocal,
    divided by the tests an iteration makes)} of each walk instantiation;
    a count that fails is left out and printed as not measured."""
    from tools import sass

    out = {}
    for key, kernel in kernels:
        try:
            code = sass.find(funcs, kernel)
            pop, _ = sass.loop_iteration(code, "FMNMX")
            tri, path = sass.loop_iteration(code, "MUFU.RCP")
            units = sum(1 for ins in path if ins.op.startswith("MUFU.RCP"))
        except (KeyError, ValueError) as e:
            log(f"  SASS {key}: not measured ({e})")
            continue
        out[f"{key}_pop"], out[f"{key}_tri"] = pop, tri / units
        log(f"  SASS: {kernel} {pop} instructions a pop of an internal node, "
            f"{tri / units:.2f} a triangle test ({units} an iteration)")
    return out


def walk_floor(counts, key, tests):
    """A walk's instruction-issue floor, ms, from its per-ray (box tests,
    triangle tests) counters: a pop of an internal node for every two slab
    tests and a triangle test for each, 32 lanes a warp instruction; None
    where the SASS was not counted."""
    from tools import sass

    if f"{key}_pop" not in counts:
        return None
    box, tri = tests.long().sum(0).tolist()
    warp_instructions = (box / 2 * counts[f"{key}_pop"]
                         + tri * counts[f"{key}_tri"]) / 32
    return sass.issue_floor_ms(warp_instructions, counts["n_sm"],
                               counts["clock_mhz"])


def issue_floor(counts, key, units):
    """Instruction-issue floor, ms: counts[key] SASS instructions for each
    of `units` warp units of work (counts: sass_counts'; None where it has
    no count)."""
    from tools import sass

    if key not in counts:
        return None
    return sass.issue_floor_ms(counts[key] * units, counts["n_sm"],
                               counts["clock_mhz"])


def atrous_warps(guides, tile, passes=4):
    """Per pass, the mean over steps 1, 2, 4, ...: K7's warps that run the
    taps (a warp is 32 lattice pixels of a tile row; it runs them if one
    of its pixels is not bypassed) and the staging iterations its blocks'
    warps run."""
    from sunray_tpu_torch.ops.cuda_image import ATROUS_HALO

    _, depth, _, rough, _ = guides
    h, w = depth.shape
    work = ~((depth >= 10000.0) | (rough < 0.1))
    tx, ty = tile
    threads = tx * ty
    staged = (tx + 2 * ATROUS_HALO) * (ty + 2 * ATROUS_HALO)
    per_block = sum(1 for it in range(-(-staged // threads))
                    for wi in range(threads // 32)
                    if wi * 32 + it * threads < staged)
    y = torch.arange(h, device=depth.device)[:, None]
    x = torch.arange(w, device=depth.device)[None, :]
    taps = stage = 0
    for i in range(passes):
        s = 1 << i
        rows, cols = -(-h // s) + 1, -(-(-(-w // s)) // tx) + 1
        key = (((y % s) * s + x % s) * rows + y // s) * cols + (x // s) // tx
        taps += torch.unique(key[work]).numel()
        blocks = sum(-(-(-(-(w - ax) // s)) // tx) * -(-(-(-(h - ay) // s)) // ty)
                     for ax in range(min(s, w)) for ay in range(min(s, h)))
        stage += blocks * per_block
    return taps / passes, stage / passes


def atrous_issue_floor(counts, guides):
    """K7's instruction-issue floor a pass, ms: the tap path's SASS count
    for each warp that runs it, the staging iteration's for each staging
    iteration (counts: sass_counts'; None where it has no count)."""
    from sunray_tpu_torch.ops.cuda_image import ATROUS_TILE
    from tools import sass

    if "atrous_taps" not in counts:
        return None
    taps, stage = atrous_warps(guides, ATROUS_TILE)
    return sass.issue_floor_ms(
        counts["atrous_taps"] * taps + counts["atrous_stage"] * stage,
        counts["n_sm"], counts["clock_mhz"])


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


# -- phase 3: kernels against their plain versions ---------------------------

def lanes_differing(xs, ys):
    """Lanes where two sequences of outputs, each (P, ...) (a Hit's t, tri,
    u, v, hit; a seed and a reservoir's fields), differ in any bit of any
    field."""
    lanes = torch.zeros(xs[0].shape[0], dtype=torch.bool, device=xs[0].device)
    for x, y in zip(xs, ys, strict=True):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        lanes |= (x != y).reshape(x.shape[0], -1).any(-1)
    return int(lanes.sum())


def compare_closest(tris, o, d, label, tmin=None, tmax=None):
    """K1 against trace_closest_brute on one query (default bounds where
    tmin/tmax are None): bit-equal on t, tri, u, v and hit."""
    from sunray_tpu_torch.ops import cuda_trace, intersect

    bounds = (intersect.T_MIN if tmin is None else tmin,
              intersect.T_MAX if tmax is None else tmax)
    k = cuda_trace.trace_closest(tris, o, d, *bounds)
    p = intersect.trace_closest_brute(tris, o, d, *bounds)
    torch.cuda.synchronize()
    differ = lanes_differing(k, p)
    agree = (k.tri == p.tri) & (k.hit == p.hit)
    frac = agree.float().mean().item()
    both = agree & p.hit
    err = max((a[both] - b[both]).abs().max().item() if both.any() else 0.0
              for a, b in ((k.t, p.t), (k.u, p.u), (k.v, p.v)))
    log(f"  K1 closest {label}: {o.shape[0]} rays x {tris[0].shape[0]} tris, "
        f"differ in any bit on {differ}, tri/hit agree {frac:.7f}, max "
        f"|t,u,v| err {err:.3g}, hit rate {p.hit.float().mean().item():.4f}")
    check(differ == 0, f"K1 {label}: {differ} rays differ from plain")
    return frac, err, k


def closest_floor(counts, n, n_tris, shape=None):
    """K1's instruction-issue floor on n rays x n_tris triangles, ms: its
    triangle loop's SASS a ray-triangle test for each warp-test its launch
    runs (every ray tests every triangle; a thread's rays at the launch
    shape `shape`, default cuda_trace.CLOSEST_SHAPE); None without a
    count."""
    from sunray_tpu_torch.ops import cuda_trace

    shape = shape or cuda_trace.CLOSEST_SHAPE
    rays = cuda_trace.rays_a_thread(n, shape)
    threads = shape[1]
    warp_tests = -(-n // (threads * rays)) * (threads // 32) * rays * n_tris
    key = f"k1_test_r{rays}"
    return issue_floor(counts, key if key in counts else "k1_test", warp_tests)


def closest_timing(counts, tris, o, d, tmin, tmax, label):
    """K1 timed on one query, beside its plain version, its bound (every ray
    tests every triangle: rays x triangles x TEST_OPS operations, against
    the rays, bounds and triangles read once and 17 bytes a ray written)
    and its issue floor."""
    from sunray_tpu_torch.ops import cuda_trace, intersect

    n, n_tris = o.shape[0], tris[0].shape[0]
    r = dict(
        rays=n,
        ms=device_ms(lambda: cuda_trace.trace_closest(tris, o, d, tmin, tmax)),
        plain_ms=time_ms(lambda: intersect.trace_closest_brute(tris, o, d, tmin,
                                                               tmax)),
        bound=bound(nbytes(o, d, tmin, tmax, *tris) + 17 * n,
                    n * n_tris * TEST_OPS),
        floor_ms=closest_floor(counts, n, n_tris))
    log(f"  K1 {label}: {n} rays x {n_tris} tris at "
        f"{cuda_trace.rays_a_thread(n, cuda_trace.CLOSEST_SHAPE)} rays a "
        f"thread; kernel {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} "
        f"({r['bound'][1]}), issue floor {r['floor_ms']} ms")
    return r


def compare_occluded(tris, o, d, tmax, exclude, label):
    from sunray_tpu_torch.ops import cuda_trace, intersect

    k = cuda_trace.trace_occluded(tris, o, d, tmax, exclude=exclude)
    p = intersect.trace_occluded_brute(tris, o, d, tmax, exclude=exclude)
    torch.cuda.synchronize()
    differ = int((k != p).sum())
    log(f"  K2 occluded {label}: {o.shape[0]} rays x {tris[0].shape[0]} tris, "
        f"exclude {'no' if exclude is None else 'yes'}, differ on {differ}, "
        f"occluded rate {p.float().mean().item():.4f}")
    check(differ == 0, f"K2 {label}: {differ} rays differ from plain")


def occluded_timing(counts, tris, o, d, tmax, exclude, label):
    """K2 timed on one query, beside its plain version, its bound (the tests
    up to each ray's first occluder), the tests its warp rule runs at the
    launch shape (warp_rule_tests) and its instruction-issue floor."""
    from sunray_tpu_torch.ops import cuda_trace, intersect

    first = occluded_first(tris, o, d, tmax, exclude)
    needed = int(first.sum())
    rays = cuda_trace.rays_a_thread(o.shape[0], cuda_trace.OCC_SHAPE)
    rule = warp_rule_tests(first, rays, cuda_trace.OCC_THREADS)
    r = dict(
        rays=o.shape[0],
        ms=device_ms(lambda: cuda_trace.trace_occluded(tris, o, d, tmax,
                                                       exclude=exclude)),
        plain_ms=time_ms(lambda: intersect.trace_occluded_brute(
            tris, o, d, tmax, exclude=exclude)),
        bound=bound(o.shape[0] * 33 + nbytes(*tris), needed * TEST_OPS),
        needed_tests=needed, rule_tests=rule,
        floor_ms=issue_floor(counts, f"k2_test_r{rays}", rule / 32))
    log(f"  K2 {label}: {o.shape[0]} rays; tests needed {needed}, run {rule} "
        f"({rule / max(needed, 1):.4f}x) at {rays} rays a thread; kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
        f"{r['bound'][0]:.4f} ({r['bound'][1]}), issue floor {r['floor_ms']} ms")
    return r


def first_occluders(hits, n_tris, o, d, tmax, exclude, step=1 << 16):
    """(N,) tests each ray of an any-hit trace needs: up to and with its
    first occluder in triangle order, else all n_tris of them. hits(o, d,
    tmax) gives a slice of rays' (B, n_tris) hit masks."""
    ids = torch.arange(n_tris, device=o.device)
    out = []
    for s in range(0, o.shape[0], step):
        sl = slice(s, s + step)
        valid = hits(o[sl], d[sl], tmax[sl, None])
        if exclude is not None:
            valid &= ids[None, :] != exclude[sl, None]
        out.append(torch.where(valid.any(dim=1), valid.int().argmax(dim=1) + 1,
                               n_tris))
    return torch.cat(out)


def occluded_first(tris, o, d, tmax, exclude):
    """first_occluders of a Moller-Trumbore any-hit trace (K2)."""
    from sunray_tpu_torch.ops import intersect

    return first_occluders(
        lambda o, d, tx: intersect.moller_trumbore(o, d, *tris, intersect.T_MIN,
                                                   tx)[3],
        tris[0].shape[0], o, d, tmax, exclude)


def trace_sets(dev, width=1920, height=1080, n_random=(65536, 4096)):
    """K1's and K2's synthetic inputs, from a generator seeded 0: the
    Cornell box's triangles and camera rays; bounce rays from the camera
    rays' hits, in uniform random directions; shadow rays from the hits to
    random points on the light, its triangle excluded, each ending 1e-3
    short; random rays against random triangles (brute_force_max_tris =
    4096), with random tmax and exclude ids for the any-hit trace."""
    from sunray_tpu_torch.camera import Camera, camera_matrices, generate_rays
    from sunray_tpu_torch.ops import intersect
    from sunray_tpu_torch.ops.brdf import normalize
    from sunray_tpu_torch.render import restir
    from sunray_tpu_torch.scene import cornell_box

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    scene = cornell_box(device=dev)
    tris = tuple(t.contiguous() for t in scene.world_triangle_vertices())
    mats = camera_matrices(Camera(**CAMERA), width, height, device=dev)
    o, d = generate_rays(mats, width, height)
    o = o.reshape(-1, 3).contiguous()
    d = d.reshape(-1, 3).contiguous()
    n = o.shape[0]
    hit = intersect.trace_closest_brute(tris, o, d)
    pos = (o + d * torch.where(hit.hit, hit.t, 1.0)[:, None]).contiguous()
    bd = normalize(randn(n, 3)).contiguous()
    lights = restir.Lights(scene)
    lidx = torch.randint(0, lights.num, (n,), generator=gen, device=dev)
    lpos, _, _, _ = lights.sample_point(lidx, rand(n), rand(n))
    sv = lpos - pos
    dist = sv.norm(dim=-1)
    sdir = (sv / dist[:, None]).contiguous()
    ex = lights.world_tri[lidx].contiguous()
    nr, nt = n_random
    v0 = randn(nt, 3)
    rtris = (v0.contiguous(), (v0 + randn(nt, 3) * 0.3).contiguous(),
             (v0 + randn(nt, 3) * 0.3).contiguous())
    ro = (randn(nr, 3) * 3.0).contiguous()
    rd = normalize(randn(nr, 3)).contiguous()
    rex = torch.randint(-1, nt, (nr,), generator=gen, device=dev,
                        dtype=torch.int32)
    rtmax = (rand(nr) * 6.0).contiguous()
    return dict(tris=tris, camera=(o, d), bounce=(pos + bd * 1e-3, bd),
                shadow=(pos, sdir, (dist - 1e-3).contiguous(), ex),
                random_tris=rtris, random=(ro, rd),
                random_occ=(ro, rd, rtmax, rex), gen=gen)


def phase_kernels(dev, counts, width=1920, height=1080):
    from sunray_tpu_torch.ops import cuda_gather, intersect
    from sunray_tpu_torch.render.shade import material_table
    from sunray_tpu_torch.scene import cornell_box

    results = {}
    sets = trace_sets(dev, width, height)
    gen = sets["gen"]
    scene_tris, rtris = sets["tris"], sets["random_tris"]
    o, d = sets["camera"]
    n = o.shape[0]

    log("phase 3: kernels against their plain versions")
    f_cam, e_cam, _ = compare_closest(scene_tris, o, d, "camera")
    f_b, e_b, _ = compare_closest(scene_tris, *sets["bounce"], "bounce")
    compare_occluded(scene_tris, *sets["shadow"], "shadow")
    f_r, e_r, _ = compare_closest(rtris, *sets["random"], "random")
    compare_occluded(rtris, *sets["random_occ"], "random")

    # K1's row: the synthetic camera set; the frames' own queries join it
    # in phase_trace_live.
    results["trace_closest"] = dict(
        closest_timing(counts, scene_tris, o, d, intersect.T_MIN,
                       intersect.T_MAX, "camera set"),
        agree=min(f_cam, f_b, f_r), max_abs_err=max(e_cam, e_b, e_r))
    random_k1 = closest_timing(counts, rtris, *sets["random"], intersect.T_MIN,
                               intersect.T_MAX, "random set")
    results["trace_closest"]["random_ms"] = random_k1["ms"]
    # K2's row: the synthetic shadow set (PR 1-7's shape); the frames' own
    # queries join it in phase_trace_live.
    results["trace_occluded"] = dict(
        occluded_timing(counts, scene_tris, *sets["shadow"], "synthetic shadow"),
        agree=1.0, max_abs_err=0.0)

    # K8: the shade pass's three fetches (render/shade.py), with
    # out-of-range indices: corners, triangle pack, material rows.
    scene = cornell_box(device=dev)
    vgeo = torch.cat([scene.positions, scene.normals], dim=1).contiguous()
    tpack = torch.cat([scene.tri_vidx, scene.tri_inst[:, None]], dim=1).contiguous()
    mtab = material_table(scene.materials)
    check(tuple(vgeo.shape) == (72, 6) and tuple(tpack.shape) == (36, 4)
          and tuple(mtab.shape) == (4, 12) and mtab.dtype == torch.float32,
          f"unexpected table shapes {tuple(vgeo.shape)} {tuple(tpack.shape)} "
          f"{tuple(mtab.shape)}")
    fetches = []
    for table, g in ((vgeo, 3), (tpack, 1), (mtab, 1)):
        k = table.shape[0]
        fetches.append((table, torch.randint(-8, k + 8, (g, n), generator=gen,
                                             device=dev, dtype=torch.int32)))
    exact = True
    for table, idx in fetches:
        k = cuda_gather.gather_rows(table, idx)
        p = cuda_gather.gather_rows_plain(table, idx)
        exact &= bool(torch.equal(k, p))
    log(f"  K8 gather_rows: 72x6 @ 3x{n}, 36x4 int32 and 4x12 float32 @ "
        f"1x{n}, bit-exact {exact}")
    check(exact, "K8 gather_rows differs from its plain version")

    def gather_timing(table, idx):
        idx_c = idx.clamp(0, table.shape[0] - 1).long()
        return dict(
            max_abs_err=0.0,
            ms=device_ms(lambda: cuda_gather.gather_rows(table, idx)),
            plain_ms=time_ms(lambda: cuda_gather.gather_rows_plain(table, idx)),
            library_ms=device_ms(lambda: table[idx_c]),
            bound=bound(nbytes(table, idx) + idx.numel() * table.shape[1] * 4, 0),
        )

    # K8b: the vertex table at 3 index vectors; K8a: the triangle pack at
    # one, and beside it the material table (the other half of K8a's
    # launches).
    results["gather_rows_multi"] = gather_timing(*fetches[0])
    results["gather_rows"] = gather_timing(*fetches[1])
    m = gather_timing(*fetches[2])
    results["gather_rows"].update(
        materials_ms=m["ms"], materials_plain_ms=m["plain_ms"],
        materials_library_ms=m["library_ms"],
        materials_bound_ms=m["bound"][0])
    log(f"  time gather_rows, material rows 4x12 @ 1x{n}: kernel "
        f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, library "
        f"{m['library_ms']:.4f} ms, bound {m['bound'][0]:.4f} ms")

    # K7: 1080p guides shaped like a G-buffer (sky band, smooth patches),
    # and the guides the live 1080p ReSTIR frame passes to atrous_denoise.
    results["atrous_pass"] = atrous_row(
        counts, synthetic_guides(gen, height, width),
        capture_denoise_inputs(dev, width, height))
    for name, r in results.items():
        log(f"  time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            + (" (per pass)" if name == "atrous_pass" else ""))
    return results


def synthetic_guides(gen, h, w):
    """(color, depth, normal, roughness, diffuse) at h x w from `gen`: a
    sky band (depth 1e5), random roughness (~10% below the 0.1 bypass)."""
    from sunray_tpu_torch.ops.brdf import normalize

    dev = gen.device
    color = (torch.rand((h, w, 3), generator=gen, device=dev) * 2.0).contiguous()
    depth = (1.0 + 3.0 * torch.rand((h, w), generator=gen, device=dev)).contiguous()
    depth[: h // 27] = 100000.0
    normal = normalize(torch.randn((h, w, 3), generator=gen, device=dev) * 0.1
                       + torch.tensor([0.0, 0.0, 1.0], device=dev)).contiguous()
    rough = torch.rand((h, w), generator=gen, device=dev).contiguous()
    diffuse = torch.rand((h, w, 3), generator=gen, device=dev).contiguous()
    return color, depth, normal, rough, diffuse


def capture_denoise_inputs(dev, width=1920, height=1080, frame=2):
    """The (color, depth, normal, roughness, diffuse) that render_frame
    passes to atrous_denoise in frame `frame` of the 1080p default ReSTIR
    render."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render import pipeline
    from sunray_tpu_torch.scene import cornell_box

    cfg = RenderConfig(width=width, height=height)
    scene = cornell_box(device=dev)
    mats = camera_matrices(Camera(**CAMERA), width, height, device=dev)
    state = pipeline.RenderState.create(cfg, dev)
    for _ in range(frame):
        state, _, _ = pipeline.render_frame(scene, cfg, state, mats)
    saved, calls = pipeline.atrous_denoise, []

    def call(*args, **kwargs):
        calls.append(tuple(a.clone() for a in args[:5]))
        return saved(*args, **kwargs)

    pipeline.atrous_denoise = call
    try:
        pipeline.render_frame(scene, cfg, state, mats)
    finally:
        pipeline.atrous_denoise = saved
    torch.cuda.synchronize()
    check(len(calls) == 1, f"frame {frame}: {len(calls)} atrous_denoise calls")
    return calls[0]


def bypass_share(guides):
    """Share of pixels the a-trous pass copies (depth >= 1e4, roughness
    < 0.1)."""
    _, depth, _, rough, _ = guides
    return ((depth >= 10000.0) | (rough < 0.1)).float().mean().item()


def atrous_row(counts, synthetic, live, passes=4):
    """K7 against the plain passes on synthetic and live-frame guides, each
    within ATROUS_ATOL; times a pass (device_ms of the `passes`-pass call
    over `passes`) and its bound: the five guide planes read and the color
    written, 24 taps of ATROUS_TAP_OPS for each pixel the bypass does not
    copy. The row's numbers are the synthetic guides'; live_* beside."""
    from sunray_tpu_torch.ops import cuda_image

    row = {}
    for label, guides in (("synthetic", synthetic), ("live", live)):
        args = (*guides, passes)
        k = cuda_image.atrous_denoise(*args)
        p = cuda_image.atrous_denoise_plain(*args)
        err = (k - p).abs().max().item()
        share = bypass_share(guides)
        h, w = guides[0].shape[:2]
        log(f"  K7 atrous {label} guides: {h}x{w}, {passes} passes, bypass "
            f"share {share:.4f}, max abs err {err:.3g}, bit-equal "
            f"{torch.equal(k, p)}")
        check(err <= ATROUS_ATOL, f"K7 {label}: error {err} > {ATROUS_ATOL}")
        work = round(h * w * (1.0 - share))
        r = dict(
            max_abs_err=err, bypass_share=share,
            ms=device_ms(lambda: cuda_image.atrous_denoise(*args)) / passes,
            plain_ms=time_ms(lambda: cuda_image.atrous_denoise_plain(*args))
            / passes,
            bound=bound(nbytes(*guides) + nbytes(guides[0]),
                        work * 24 * ATROUS_TAP_OPS),
            floor_ms=atrous_issue_floor(counts, guides))
        log(f"  K7 {label}: kernel {r['ms']:.4f} ms a pass, plain "
            f"{r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} ({r['bound'][1]}), "
            f"issue floor {r['floor_ms']} ms")
        if label == "synthetic":
            row = r
        else:
            row.update({f"live_{key}": val for key, val in r.items()
                        if key != "bound"})
            row["live_bound_ms"] = r["bound"][0]
    row["max_abs_err"] = max(row["max_abs_err"], row["live_max_abs_err"])
    return row


# -- phase 3, K3-K6: the ReSTIR kernels on a live frame's inputs ---------------

RESTIR_WRAPPERS = {
    "ris_audition": "ris_audition_plain",
    "di_temporal": "di_temporal_plain",
    "di_spatial": "di_spatial_plain",
    "gi_spatial": "gi_spatial_plain",
}
# What each kernel's outputs are held to: (winner id, exact fields,
# {field: (rtol, atol)} compared on lanes whose winner agrees).
RESTIR_CHECKS = {
    "ris_audition": ("light_idx", ("M",),
                     {"w_sum": (5e-4, 1e-6), "light_pos": (1e-5, 1e-6),
                      "W": (3e-4, 1e-5)}),
    "di_temporal": ("light_idx", ("M",),
                    {"w_sum": (5e-4, 1e-6), "light_pos": (1e-5, 1e-6),
                     "W": (3e-4, 1e-5)}),
    "di_spatial": ("light_idx", ("M", "has"),
                   {"w_sum": (5e-4, 1e-6), "light_pos": (1e-5, 1e-6),
                    "w_spatial": (3e-4, 1e-5), "f_y_w": (3e-4, 1e-5)}),
    "gi_spatial": ("sample_tri", ("try_gi",),
                   {"gdir": (1e-5, 1e-6), "gdist": (1e-5, 1e-6),
                    "contrib_pre": (3e-4, 1e-5)}),
}


def capture_frames(dev, wrappers, frame, count, width=1920, height=1080,
                   scene=None, **cfg_kw):
    """Every call, (args, kwargs), of the wrappers `wrappers` ({name: module
    under sunray_tpu_torch.ops}) in frames frame, ..., frame + count - 1
    (the frames before them run unrecorded) of the width x height render of
    `scene` (default: the Cornell box) with RenderConfig(**cfg_kw): one
    {name: [calls]} a frame."""
    import importlib

    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    cfg = RenderConfig(width=width, height=height, **cfg_kw)
    scene = cornell_box(device=dev) if scene is None else scene
    mats = camera_matrices(Camera(**CAMERA), width, height, device=dev)
    state = RenderState.create(cfg, dev)
    for _ in range(frame):
        state, _, _ = render_frame(scene, cfg, state, mats)
    mods = {name: importlib.import_module(f"sunray_tpu_torch.ops.{mod}")
            for name, mod in wrappers.items()}
    saved = {name: getattr(mods[name], name) for name in wrappers}
    frames = []

    def wrap(name):
        def call(*args, **kwargs):
            frames[-1][name].append((args, kwargs))
            return saved[name](*args, **kwargs)
        return call

    try:
        for name in wrappers:
            setattr(mods[name], name, wrap(name))
        for _ in range(count):
            frames.append({name: [] for name in wrappers})
            state, _, _ = render_frame(scene, cfg, state, mats)
    finally:
        for name, fn in saved.items():
            setattr(mods[name], name, fn)
    torch.cuda.synchronize()
    return frames


def capture_calls(dev, wrappers, frame, width=1920, height=1080, scene=None,
                  **cfg_kw):
    """capture_frames of frame `frame` alone: {name: [(args, kwargs)]}."""
    return capture_frames(dev, wrappers, frame, 1, width, height, scene,
                          **cfg_kw)[0]


# The default ReSTIR frame's three K2 queries, in the order the frame makes
# them: pass 1's DI visibility with the GI sample's NEE ray (2P rays,
# render/gbuffer.py), pass 2's GI-tap visibility (3P) and its DI winner
# shadow ray with the GI final visibility ray (2P, render/pathtrace.py).
RESTIR_OCCLUDED = ("DI visibility + GI NEE", "GI-tap visibility",
                   "DI winner + GI final")


# ... and its two K1 queries: pass 1's camera rays and the GI initial
# sample (render/gbuffer.py).
RESTIR_CLOSEST = ("camera", "GI initial sample")
# Frames whose K5 inputs are timed: the shared tap offsets change every
# frame, and with them the rows a tap reads.
K5_FRAMES = 4


def capture_restir_inputs(dev, width=1920, height=1080, frame=2,
                          frames=K5_FRAMES):
    """What the kernels got in frames frame, ..., frame + frames - 1 of a
    default ReSTIR render at width x height: a dict of "args", the
    arguments of each K3-K6 wrapper in frame `frame`; "occluded" and
    "closest", every K2 and K1 call of that frame, (args, kwargs), in
    order; "di_spatial", K5's arguments in each recorded frame."""
    wrappers = dict.fromkeys(RESTIR_WRAPPERS, "cuda_restir")
    recorded = capture_frames(dev, dict(wrappers, trace_occluded="cuda_trace",
                                        trace_closest="cuda_trace"),
                              frame, frames, width, height)
    calls = recorded[0]
    check(all(calls[name] for name in RESTIR_WRAPPERS),
          f"frame {frame} called only {[k for k, v in calls.items() if v]}")
    check(len(calls["trace_occluded"]) == len(RESTIR_OCCLUDED),
          f"frame {frame}: {len(calls['trace_occluded'])} K2 calls")
    check(len(calls["trace_closest"]) == len(RESTIR_CLOSEST),
          f"frame {frame}: {len(calls['trace_closest'])} K1 calls")
    check(all(len(c["di_spatial"]) == 1 for c in recorded),
          f"K5 calls a frame: {[len(c['di_spatial']) for c in recorded]}")
    return dict(args={name: calls[name][0][0] for name in RESTIR_WRAPPERS},
                occluded=calls["trace_occluded"],
                closest=calls["trace_closest"],
                di_spatial=[c["di_spatial"][0][0] for c in recorded])


def compare_restir(name, args, label, kwargs=None):
    """Kernel against plain on the same arguments (args, kwargs); returns
    (agree, err)."""
    from sunray_tpu_torch.ops import cuda_restir

    kwargs = kwargs or {}
    seed_k, out_k = getattr(cuda_restir, name)(*args, **kwargs)
    seed_p, out_p = getattr(cuda_restir, RESTIR_WRAPPERS[name])(*args,
                                                                **kwargs)
    torch.cuda.synchronize()
    win, exact, close = RESTIR_CHECKS[name]
    check(torch.equal(seed_k, seed_p), f"{name} {label}: seeds differ")
    for key in exact:
        check(torch.equal(out_k[key], out_p[key]),
              f"{name} {label}: {key} differs")
    same = out_k[win] == out_p[win]
    agree = same.float().mean().item()
    err = 0.0
    for key, (rtol, atol) in close.items():
        a, b = out_k[key][same], out_p[key][same]
        if a.numel():
            err = max(err, (a - b).abs().max().item())
            check(torch.allclose(a, b, rtol=rtol, atol=atol),
                  f"{name} {label}: {key} off by {(a - b).abs().max().item()}")
    log(f"  {name} {label}: winner agree {agree:.7f}, max abs err on agreeing "
        f"lanes {err:.3g}")
    check(agree > WINNER_AGREE, f"{name} {label}: agreement {agree}")
    return agree, err


def flatten(x):
    """Every tensor inside nested tuples, lists, dicts and dataclasses."""
    import dataclasses

    if torch.is_tensor(x):
        return [x]
    if dataclasses.is_dataclass(x):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    elif not isinstance(x, (tuple, list)):
        return []
    return [t for item in x for t in flatten(item)]


def restir_lane_ops(name, args):
    """fp32 operations per lane, counted from csrc/restir.cu: a candidate's
    light sample and target function ~150 (K3), a temporal merge ~300
    (K4), a spatial tap's test, target and merge ~200 (K5) and ~150 (K6),
    plus ~300 / ~200 for the centre and the resolve."""
    if name == "ris_audition":
        return 150 * args[8]
    if name == "di_temporal":
        return 300
    if name == "di_spatial":
        return 300 + 200 * len(args[3])
    return 200 + 150 * args[2]["ok"].shape[0]


def random_audition_args(dev, n_lights, lanes=65536, seed=1):
    """K3's arguments on a random table of n_lights lights and `lanes`
    random surfaces (K = 16, ~80% of lanes enabled), from a generator
    seeded `seed`."""
    from sunray_tpu_torch.ops import cuda_restir

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    def unit(n):
        v = torch.randn((n, 3), generator=gen, device=dev)
        return (v / v.norm(dim=-1, keepdim=True)).contiguous()

    v0 = rand(n_lights, 3, lo=0.0, hi=2.0)
    table = cuda_restir.LightTable(
        v0, (v0 + rand(n_lights, 3, lo=-0.3, hi=0.3)).contiguous(),
        (v0 + rand(n_lights, 3, lo=-0.3, hi=0.3)).contiguous(),
        rand(n_lights, 3, lo=0.0, hi=20.0))
    seeds = torch.randint(0, 2**32, (lanes,), generator=gen, device=dev,
                          dtype=torch.int64)
    return (table, seeds, rand(lanes, 3, lo=0.0, hi=2.0), unit(lanes),
            unit(lanes), rand(lanes, 3), rand(lanes, lo=0.05), rand(lanes), 16,
            rand(lanes) > 0.2)


def di_spatial_use(args):
    """(T, P) bool: the lanes for which K5 evaluates tap t, whose neighbour
    is on the image, passes the normal and depth test and holds a usable
    reservoir (csrc/restir.cu di_spatial_kernel's `use`)."""
    from sunray_tpu_torch.ops import cuda_restir

    (table, _, center, taps, pending, gnormal, gdepth, cur, _, normal, *_,
     width, height, clamps) = args
    out = []
    for dx, dy in taps:
        ok, _ = cuda_restir.neighbour_ok(dx, dy, width, height, normal, cur,
                                         gnormal, gdepth)
        w = cuda_restir.shift_flat(center["W"], dx, dy, height, width)
        idx = cuda_restir.shift_flat(center["light_idx"], dx, dy, height, width)
        out.append(pending & ok & (torch.clamp(w, max=clamps[0]) > 0.0)
                   & (idx < table.num))
    return torch.stack(out) if out else torch.zeros((0, pending.shape[0]),
                                                    dtype=torch.bool,
                                                    device=pending.device)


def warps_any(mask):
    """Warps of a one-lane-a-thread launch over mask's last axis that hold a
    lane where mask is true, summed over its leading axes."""
    n = mask.shape[-1]
    pad = torch.zeros((*mask.shape[:-1], -(-n // 32) * 32), dtype=torch.bool,
                      device=mask.device)
    pad[..., :n] = mask
    return int(pad.reshape(*mask.shape[:-1], -1, 32).any(dim=-1).sum())


def di_spatial_floor(counts, args):
    """K5's instruction-issue floor, ms: the path through the centre merge and
    the resolve (every MUFU outside the tap loop) on every warp, and a used
    tap's iteration (a PCG draw, the neighbour test and the target function)
    on each warp that uses the tap (di_spatial_use); None without a count."""
    from tools import sass

    if "k5_fixed" not in counts:
        return None
    n = args[4].shape[0]
    warps = -(-n // 32)
    return sass.issue_floor_ms(
        counts["k5_fixed"] * warps
        + counts["k5_tap"] * warps_any(di_spatial_use(args)),
        counts["n_sm"], counts["clock_mhz"])


def centre_kept_warps(args, out):
    """Share of K5's warps whose every lane ends with the centre's own
    sample (light id, position and normal bit-equal to the centre's, which
    the centre merge took): warps where the resolve's target function
    equals the centre's."""
    center = args[2]
    n_l = args[0].num
    same = ((out["light_idx"] == torch.clamp(center["light_idx"], max=n_l - 1))
            & (out["light_pos"].view(torch.int32)
               == center["light_pos"].view(torch.int32)).all(-1)
            & (out["light_normal"].view(torch.int32)
               == center["light_normal"].view(torch.int32)).all(-1)
            & (out["w_sum"] > 0.0))
    n = same.shape[0]
    return 1.0 - warps_any(~same) / -(-n // 32), same.float().mean().item()


def reservoir_fields(result):
    """A K3-K6 result (seed', {field: tensor}) as one sequence: the seed,
    then the fields in name order."""
    seed, out = result
    return [seed, *(out[k] for k in sorted(out))]


def phase_restir_kernels(dev, counts, n_lights=600):
    """K3-K6 against their plain versions on frame 2's inputs, K3 also on a
    random table of n_lights lights, K5 also on frames 3-5's; returns (rows,
    capture_restir_inputs' record)."""
    from sunray_tpu_torch.ops import cuda_restir

    log("phase 3: K3-K6 against their plain versions")
    cap = capture_restir_inputs(dev)
    results = {}
    for name, args in cap["args"].items():
        agree, err = compare_restir(name, args, "1080p frame 2")
        results[name] = dict(agree=agree, max_abs_err=err, args=args)

    # K3 on a random table of many lights (shared-memory table) and
    # random surfaces.
    lights_args = random_audition_args(dev, n_lights)
    agree, err = compare_restir("ris_audition", lights_args,
                                f"{lights_args[1].shape[0]} lanes x {n_lights} "
                                "lights")
    r = results["ris_audition"]
    r["agree"] = min(r["agree"], agree)
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["lights600_ms"] = device_ms(lambda: cuda_restir.ris_audition(*lights_args))
    # the warps that run the candidates (a warp of disabled lanes only
    # draws)
    warps = warps_any(r["args"][9])
    r["floor_ms"] = issue_floor(counts, "k3_candidate", warps * r["args"][8])
    log(f"  K3 frame 2: {warps} warps with an enabled lane x "
        f"{r['args'][8]} candidates; issue floor {r['floor_ms']} ms; "
        f"{n_lights}-light table {r['lights600_ms']:.4f} ms")

    # K5 on frames 2-5: bit-equality with plain, the taps' use, the share
    # of warps that keep the centre's sample, its floor and time.
    r = results["di_spatial"]
    r["frames"] = []
    for f, args in enumerate(cap["di_spatial"], start=2):
        if f > 2:
            agree, err = compare_restir("di_spatial", args, f"1080p frame {f}")
            r["agree"] = min(r["agree"], agree)
            r["max_abs_err"] = max(r["max_abs_err"], err)
        k = cuda_restir.di_spatial(*args)
        differ = lanes_differing(reservoir_fields(k),
                                 reservoir_fields(cuda_restir.di_spatial_plain(*args)))
        use = di_spatial_use(args)
        kept, kept_lanes = centre_kept_warps(args, k[1])
        q = dict(frame=f, taps=[list(t) for t in args[3]],
                 ms=device_ms(lambda: cuda_restir.di_spatial(*args)),
                 floor_ms=di_spatial_floor(counts, args),
                 lanes_differing=differ,
                 tap_use=[round(u.float().mean().item(), 6) for u in use],
                 centre_kept_warps=kept)
        r["frames"].append(q)
        log(f"  K5 frame {f}: taps {args[3]}; lanes differing from plain in "
            f"any bit {differ}; tap use {q['tap_use']}; lanes keeping the "
            f"centre's sample {kept_lanes:.4f}, warps {kept:.4f}; kernel "
            f"{q['ms']:.4f} ms, issue floor {q['floor_ms']} ms")
    times = [q["ms"] for q in r["frames"]]
    r["frames_ms_spread"] = [min(times), max(times)]
    r["floor_ms"] = r["frames"][0]["floor_ms"]

    for name, r in results.items():
        args = r.pop("args")
        lanes = (args[0] if name == "gi_spatial" else args[1]).shape[0]
        out = getattr(cuda_restir, name)(*args)
        r["bound"] = bound(nbytes(*flatten(args)) + nbytes(*flatten(out)),
                           lanes * restir_lane_ops(name, args))
        r["ms"] = device_ms(lambda: getattr(cuda_restir, name)(*args))
        r["plain_ms"] = time_ms(
            lambda: getattr(cuda_restir, RESTIR_WRAPPERS[name])(*args))
        log(f"  time {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
    return results, cap


def phase_trace_live(dev, counts, cap, rows, width=1920, height=1080,
                     frame=2):
    """K2 and K1 on the frames' own queries: frame 2 of the default 1080p
    ReSTIR frame's (cap, from capture_restir_inputs: three K2 and two K1
    queries) and frame 2 of the 1080p NEE frame's (K2 its first bounce
    round, K1 every call); each bit-equal to plain on every lane and timed
    as occluded_timing and closest_timing time them. Adds them to K2's and
    K1's rows (rows["trace_occluded"], rows["trace_closest"]) as live_*
    entries."""
    from sunray_tpu_torch.ops.intersect import T_MIN

    log("phase 3: K2 and K1 on the frames' own queries")
    nee = capture_calls(dev, dict(trace_occluded="cuda_trace",
                                  trace_closest="cuda_trace"), frame, width,
                        height, lighting="nee")
    check(nee["trace_occluded"] and nee["trace_closest"],
          f"NEE frame {frame} made {len(nee['trace_occluded'])} K2 and "
          f"{len(nee['trace_closest'])} K1 calls")
    for kid, name in (("K2", "trace_occluded"), ("K1", "trace_closest")):
        log(f"  NEE frame {frame}: {len(nee[name])} {kid} calls of "
            f"{sorted({a[1].shape[0] for a, _ in nee[name]})} rays")

    row = rows["trace_occluded"]
    queries = [*zip(RESTIR_OCCLUDED, cap["occluded"]),
               ("NEE bounce round 0", nee["trace_occluded"][0])]
    live = []
    for label, (args, kwargs) in queries:
        tris, o, d, tmax, tmin = args
        check(tmin == T_MIN and set(kwargs) == {"exclude"},
              f"K2 {label}: unexpected arguments")
        ex = kwargs["exclude"]
        compare_occluded(tris, o, d, tmax, ex, label)
        r = occluded_timing(counts, tris, o, d, tmax, ex, label)
        live.append(dict(query=label, rays=r["rays"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                         needed_tests=r["needed_tests"],
                         rule_tests=r["rule_tests"], floor_ms=r["floor_ms"]))
    row["live"] = live
    row["live_restir_frame_ms"] = sum(q["ms"] for q in live[:3])
    row["live_restir_frame_bound_ms"] = sum(q["bound_ms"] for q in live[:3])
    row["nee_calls_per_frame"] = len(nee["trace_occluded"])
    log(f"  K2 a ReSTIR frame (3 queries): kernel "
        f"{row['live_restir_frame_ms']:.4f} ms, bound "
        f"{row['live_restir_frame_bound_ms']:.4f} ms")

    row = rows["trace_closest"]
    queries = [*((f"ReSTIR {label}", c)
                 for label, c in zip(RESTIR_CLOSEST, cap["closest"])),
               *((f"NEE call {i}", c) for i, c in enumerate(nee["trace_closest"]))]
    live = []
    for label, (args, kwargs) in queries:
        check(len(args) == 5 and not kwargs, f"K1 {label}: unexpected arguments")
        tris, o, d, tmin, tmax = args
        compare_closest(tris, o, d, label, tmin, tmax)
        r = closest_timing(counts, tris, o, d, tmin, tmax, label)
        live.append(dict(query=label, rays=r["rays"], ms=r["ms"],
                         plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                         floor_ms=r["floor_ms"]))
    row["live"] = live
    n_restir = len(RESTIR_CLOSEST)
    row["live_restir_frame_ms"] = sum(q["ms"] for q in live[:n_restir])
    row["live_restir_frame_bound_ms"] = sum(q["bound_ms"]
                                            for q in live[:n_restir])
    row["live_nee_frame_ms"] = sum(q["ms"] for q in live[n_restir:])
    row["nee_calls_per_frame"] = len(nee["trace_closest"])
    log(f"  K1 a ReSTIR frame ({n_restir} queries): kernel "
        f"{row['live_restir_frame_ms']:.4f} ms, bound "
        f"{row['live_restir_frame_bound_ms']:.4f} ms; an NEE frame "
        f"({row['nee_calls_per_frame']} queries): kernel "
        f"{row['live_nee_frame_ms']:.4f} ms")


# -- phase 3, K9, K13, K14: the kernel switches on a live frame's inputs ------

SWITCH_WRAPPERS = {
    "taa_clamp_blend": "cuda_image",
    "history_gather": "cuda_history",
    "trace_occluded_woop": "cuda_trace",
}


def capture_switch_inputs(dev, width=1920, height=1080, frame=3):
    """Every call of the K9, K13 and K14 wrappers, (args, kwargs), in frame
    `frame` of the 1080p Cornell ReSTIR render with the kernel switches
    (frame 3: TAA reads history from frame_count 3 on)."""
    calls = capture_calls(dev, SWITCH_WRAPPERS, frame, width, height,
                          **SWITCHES)
    check(len(calls["taa_clamp_blend"]) == 1 and len(calls["history_gather"]) == 2
          and calls["trace_occluded_woop"],
          f"frame {frame}: wrapper calls {({k: len(v) for k, v in calls.items()})}")
    return calls


def woop_first(woop, o, d, tmax, exclude):
    """first_occluders of a Woop any-hit trace (K14)."""
    from sunray_tpu_torch.ops import intersect

    return first_occluders(
        lambda o, d, tx: intersect.woop_hits(woop, o, d, intersect.T_MIN, tx),
        woop[0].shape[1], o, d, tmax, exclude)


def warp_rule_tests(first, rays, threads=128):
    """Tests K14 or K2 runs for rays needing `first` tests each: thread t of
    block b traces rays b * threads * rays + t + j * threads (j < rays) and
    tests all of them against each triangle until every one is decided; a
    warp issues each triangle's tests until its last thread is done."""
    per = threads * rays
    nb = -(-first.shape[0] // per)
    f = torch.zeros(nb * per, dtype=first.dtype, device=first.device)
    f[:first.shape[0]] = first
    iters = f.reshape(nb, rays, threads // 32, 32).amax(dim=(1, 3))
    return int(iters.sum()) * 32 * rays


def phase_switch_kernels(dev, counts):
    from sunray_tpu_torch.ops import cuda_history, cuda_image, cuda_trace, intersect

    log("phase 3: K9, K13, K14 against their plain versions (1080p switches "
        "frame 3's inputs)")
    calls = capture_switch_inputs(dev)
    results = {}

    # K9 on the frame's raw, history and use mask.
    (taa_args, _), = calls["taa_clamp_blend"]
    raw, hist, use, factor = taa_args
    k = cuda_image.taa_clamp_blend(*taa_args)
    p = cuda_image.taa_clamp_blend_plain(*taa_args)
    torch.cuda.synchronize()
    err = (k - p).abs().max().item()
    share = use.float().mean().item()
    log(f"  K9 taa_clamp_blend: {tuple(raw.shape)}, use share {share:.4f}, "
        f"bit-equal {torch.equal(k, p)}, max abs err {err:.3g}")
    check(err <= TAA_ATOL, f"K9 error {err} > {TAA_ATOL}")
    check(share > 0.5, f"K9: history used on only {share} of pixels")
    n_px = use.numel()
    results["taa_clamp_blend"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: cuda_image.taa_clamp_blend(*taa_args)),
        plain_ms=time_ms(lambda: cuda_image.taa_clamp_blend_plain(*taa_args)),
        # raw, history, mask read once, the image written once; ~120 fp32
        # operations a pixel (9 luminances, 8 gated min/max, clamp, blend)
        bound=bound(nbytes(raw, hist, use) + nbytes(raw), n_px * 120))

    # K13 on the joint DI+GI read (ris_pass) and the TAA corners.
    timed = {}
    for (args, _), label in zip(calls["history_gather"],
                                ("joint DI+GI read", "TAA corners")):
        fields, idx = args
        k = cuda_history.history_gather(fields, idx)
        p = cuda_history.history_gather_plain(fields, idx)
        torch.cuda.synchronize()
        exact = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(k, p))
        words = sum(f[0].numel() for f in fields)
        log(f"  K13 history_gather {label}: {idx.shape[0]} lanes x {words} words "
            f"({len(fields)} fields), bit-equal {exact}")
        check(exact, f"K13 {label} differs from its plain version")
        timed[label] = (fields, idx, words)
    fields, idx, words = timed["joint DI+GI read"]
    m = idx.shape[0]
    packed = torch.cat([f.view(torch.float32).reshape(f.shape[0], -1)
                        for f in fields], dim=1).contiguous()
    corners = timed["TAA corners"]
    results["history_gather"] = dict(
        max_abs_err=0.0,
        ms=device_ms(lambda: cuda_history.history_gather(fields, idx)),
        plain_ms=time_ms(lambda: cuda_history.history_gather_plain(fields, idx)),
        library_ms=device_ms(lambda: packed.index_select(0, idx)),
        taa_corners_ms=device_ms(lambda: cuda_history.history_gather(*corners[:2])),
        bound=bound(nbytes(idx) + 2 * m * words * 4, 0))
    r = results["history_gather"]
    log(f"  K13 joint read: kernel {r['ms']:.4f} ms, index_select on the packed "
        f"table {r['library_ms']:.4f} ms, kernel at {r['bound'][0] / r['ms']:.1%} "
        f"of the bound; TAA corners {r['taa_corners_ms']:.4f} ms")

    # K14 on every shadow query of the frame, with its exclude ids.
    agree, err, worst = [], 0.0, None
    for args, kwargs in calls["trace_occluded_woop"]:
        woop, o, d, tmax, tmin = args
        exclude = kwargs.get("exclude")
        k = cuda_trace.trace_occluded_woop(woop, o, d, tmax, tmin, exclude=exclude)
        p = intersect.trace_occluded_woop(woop, o, d, tmax, tmin, exclude=exclude)
        torch.cuda.synchronize()
        differ = int((k != p).sum())
        frac = 1.0 - differ / p.numel()
        log(f"  K14 trace_occluded_woop: {o.shape[0]} rays x {woop[0].shape[1]} "
            f"tris, exclude {'yes' if exclude is not None else 'no'}, differ on "
            f"{differ} (agree {frac:.7f}), occluded rate "
            f"{p.float().mean().item():.4f}")
        check(frac >= TRACE_AGREE, f"K14: agreement {frac} < {TRACE_AGREE}")
        agree.append(frac)
        err = max(err, float(differ > 0))
        if worst is None or o.shape[0] > worst[1].shape[0]:
            worst = (woop, o, d, tmax, tmin, exclude)
    woop, o, d, tmax, tmin, exclude = worst
    check(tmin == intersect.T_MIN, "shadow query with a non-default tmin")
    first = woop_first(woop, o, d, tmax, exclude)
    rule = warp_rule_tests(first, cuda_trace.WOOP_RAYS, cuda_trace.WOOP_THREADS)
    results["trace_occluded_woop"] = dict(
        agree=min(agree), max_abs_err=err,
        ms=device_ms(lambda: cuda_trace.trace_occluded_woop(
            woop, o, d, tmax, tmin, exclude=exclude)),
        plain_ms=time_ms(lambda: intersect.trace_occluded_woop(
            woop, o, d, tmax, tmin, exclude=exclude)),
        bound=bound(o.shape[0] * 33 + nbytes(*woop),
                    int(first.sum()) * WOOP_OPS),
        needed_tests=int(first.sum()), rule_tests=rule,
        # a triangle-loop iteration tests WOOP_RAYS rays a thread
        floor_ms=issue_floor(counts, "woop_loop",
                             rule / (32 * cuda_trace.WOOP_RAYS)))
    r = results["trace_occluded_woop"]
    log(f"  K14 tests: needed {r['needed_tests']}, run {rule} as "
        f"warp_rule_tests models the kernel ({rule / r['needed_tests']:.4f}x) "
        f"at {cuda_trace.WOOP_RAYS} rays a thread; issue floor {r['floor_ms']} ms")
    log(f"  K14 timed on the {o.shape[0]}-ray query")
    for name, r in results.items():
        log(f"  time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
            f", bound {r['bound'][0]:.4f} ms ({r['bound'][1]})"
            + (f", library {r['library_ms']:.4f} ms" if "library_ms" in r else ""))
    return results


# -- phase 6, K10-K12: the binned tracer on a live big-mesh frame's rays ------

def capture_binned_rays(dev, width=1920, height=1080, frame=2):
    """The frame's refit ClusterSet and three queries the tracer got in
    frame `frame` of the 1080p big-mesh render: pass 1's first coherent
    closest query (the camera rays, orig, d), its last incoherent one (the
    GI bounce, orig, d), and pass 2's largest incoherent any-hit query (the
    GI taps' visibility, 3P rays: orig, d, tmax, exclude)."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import binned_trace
    from sunray_tpu_torch.ops.intersect import T_MIN
    from sunray_tpu_torch.render import gbuffer, pathtrace
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame

    cfg = RenderConfig(width=width, height=height)
    scene = big_scene(dev)
    accel = big_accel(scene, cfg)
    mats = camera_matrices(Camera(**CAMERA), width, height, device=dev)
    state = RenderState.create(cfg, dev)
    for _ in range(frame):
        state, _, _ = render_frame(scene, cfg, state, mats, accel)
    closest, occluded = [], []
    saved = gbuffer.trace_closest, pathtrace.trace_occluded

    def record_closest(ctx, orig, d, *args, coherent=True, **kw):
        closest.append((orig, d, coherent))
        return saved[0](ctx, orig, d, *args, coherent=coherent, **kw)

    def record_occluded(ctx, orig, d, tmax, tmin=T_MIN, exclude=None,
                        coherent=True):
        check(tmin == T_MIN, "visibility query with a non-default tmin")
        occluded.append((orig, d, tmax, exclude, coherent))
        return saved[1](ctx, orig, d, tmax, tmin, exclude, coherent)

    gbuffer.trace_closest = record_closest
    pathtrace.trace_occluded = record_occluded
    try:
        render_frame(scene, cfg, state, mats, accel)
    finally:
        gbuffer.trace_closest, pathtrace.trace_occluded = saved
    torch.cuda.synchronize()
    camera = [c[:2] for c in closest if c[2]]
    bounce = [c[:2] for c in closest if not c[2]]
    vis = [c[:4] for c in occluded if not c[4] and c[3] is not None]
    check(camera and bounce and vis, f"frame {frame} made no coherent or no "
          "incoherent closest query, or no incoherent any-hit query")
    cs = binned_trace.refit_cluster_set(
        accel, tuple(t.contiguous() for t in scene.world_triangle_vertices()))
    return cs, camera[0], bounce[-1], max(vis, key=lambda c: c[0].shape[0])


def compare_hits(name, k, p, label, live=None):
    """Closest results (t, tri, u, v) of a kernel and its plain version on
    the lanes `live` (all if None): (fraction of those lanes with equal
    tri, max |t,u,v| error where they agree)."""
    torch.cuda.synchronize()
    if live is not None:
        k, p = [x[live] for x in k], [x[live] for x in p]
    agree = k[1] == p[1]
    n, differ = agree.numel(), int((~agree).sum())
    frac = 1.0 - differ / n
    both = agree & (p[1] >= 0)
    err = max(((a[both] - b[both]).abs().max().item() if both.any() else 0.0)
              for a, b in ((k[0], p[0]), (k[2], p[2]), (k[3], p[3])))
    log(f"  {name} closest {label}: {n} lanes, tri/hit differ on {differ} "
        f"(agree {frac:.7f}), max |t,u,v| err {err:.3g}, hit rate "
        f"{(p[1] >= 0).float().mean().item():.4f}")
    check(frac >= TRACE_AGREE, f"{name} {label}: agreement {frac}")
    check(err <= UVT_ATOL, f"{name} {label}: t/u/v error {err}")
    return frac, err


def compare_occ(name, k, p, label, live=None):
    torch.cuda.synchronize()
    if live is not None:
        k, p = k[live], p[live]
    n, differ = p.numel(), int((k != p).sum())
    frac = 1.0 - differ / n
    log(f"  {name} any-hit {label}: {n} lanes, differ on {differ} (agree "
        f"{frac:.7f}), occluded rate {p.float().mean().item():.4f}")
    check(frac >= TRACE_AGREE, f"{name} {label}: agreement {frac}")
    return frac


def block_args(cs, orig, d, tmax, exclude):
    """K10's inputs for (N, 3) rays, as trace_*_binned(reorder=True) makes
    them: coherence sort, padding to blocks, cull and work lists."""
    from sunray_tpu_torch.ops import binned_trace as bt
    from sunray_tpu_torch.ops.intersect import T_MIN

    o_s, d_s, tx_s, ex_s, _ = bt._reorder_rays(cs, orig, d, tmax, exclude)
    o_t, d_t, tn, tx, ex, _, nb = bt._prep(o_s, d_s, T_MIN, tx_s, ex_s)
    hit, entry = bt._interval_cull(o_t, d_t, tn, tx, cs.aabb_lo, cs.aabb_hi, nb)
    order, ents, count = bt._work_list(hit, entry)
    return (order, ents, count, o_t, d_t, tn, tx, ex, cs)


def box_entered(o, d, lower, upper, lo, hi):
    """Whether each ray (o, d: (..., 3)) enters the box [lo, hi] (..., 3)
    at a t in [lower, upper] (broadcasting; K11's slab test)."""
    from sunray_tpu_torch.ops.cuda_binned import _inv

    inv = _inv(d)
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    tnear = torch.minimum(t1, t2).amax(dim=-1)
    tfar = torch.maximum(t1, t2).amin(dim=-1)
    return (tnear <= tfar) & (tfar >= lower) & (tnear <= upper)


def needed_block_tests(cs, o_t, d_t, tn, tx, t_hit, step=1 << 14):
    """Cluster tests a closest-hit query needs, whatever the walk: for each
    ray lane, the clusters whose box it enters between tmin and its
    closest hit (its tmax on a miss); each of these could hold a nearer
    hit, the others cannot. Lanes with tmax = -inf need none."""
    total = 0
    upper = torch.minimum(tx, t_hit)
    for s in range(0, tn.shape[0], step):
        sl = slice(s, s + step)
        total += int(box_entered(o_t[:, sl].T[:, None], d_t[:, sl].T[:, None],
                                 tn[sl, None], upper[sl, None], cs.aabb_lo,
                                 cs.aabb_hi).sum())
    return total


def needed_pair_tests(cs, pair_args, t_pair=None, occ=None, step=1 << 20):
    """Cluster tests the pair lanes of one K12 launch need, whatever the
    walk: for each live lane, the clusters of its supercluster whose box
    its ray enters between the first ray's tmin (as K12 reads it) and its
    closest hit (t_pair, K12's closest t per pair position; its tmax on a
    miss); any-hit (occ, K12's result per pair position): one for each
    occluded lane (its occluder's cluster), and for each other lane the
    clusters whose box its segment [tmin, tmax] enters."""
    from sunray_tpu_torch.ops.cuda_binned import SC_K

    cid_s, pos_s, _, o_t, d_t, tn, tx, _, _, n_sc = pair_args
    c, nl = cs.num_clusters, tn.shape[0]
    live = torch.nonzero(cid_s < n_sc)[:, 0]
    total = 0
    if occ is not None:
        hit = occ[pos_s[live].long()]
        total += int(hit.sum())
        live = live[~hit]
    sub = torch.arange(SC_K, device=cid_s.device)
    for s in range(0, live.shape[0], step):
        lane = live[s:s + step]
        pos = pos_s[lane].long()
        ray = pos % nl
        cl = cid_s[lane].long()[:, None] * SC_K + sub[None, :]
        ok = cl < c
        cl = cl.clamp(max=c - 1)
        upper = tx[ray] if t_pair is None else torch.minimum(tx[ray], t_pair[pos])
        hit = box_entered(o_t[:, ray].T[:, None], d_t[:, ray].T[:, None], tn[0],
                          upper[:, None], cs.aabb_lo[cl], cs.aabb_hi[cl])
        total += int((hit & ok).sum())
    return total


def compare_k10(args, closest, label, live=None):
    """K10 against its plain version on one launch's inputs: the lanes
    `live` (all if None) bit-equal, and so is the plain model of the
    kernel's walk (binned_round_warp), whose count of the tests it runs is
    returned with the agreement: (agreement, error, rule tests)."""
    from sunray_tpu_torch.ops import cuda_binned as cb

    k = cb.binned_round(*args, closest=closest)
    p = cb.binned_round_plain(*args, closest=closest)
    model, rule = cb.binned_round_warp(*args, closest=closest)
    torch.cuda.synchronize()
    if closest:
        frac, err = compare_hits("K10", k, p, label, live)
    else:
        frac, err = compare_occ("K10", k, p, label, live), 0.0
    sel = (lambda x: x) if live is None else (lambda x: x[live])  # noqa: E731
    for name, out in (("kernel", k), ("walk model", model)):
        same = (all(torch.equal(sel(a).view(torch.int32), sel(b).view(torch.int32))
                    for a, b in zip(out, p)) if closest
                else torch.equal(sel(out), sel(p)))
        check(same, f"K10 {label}: the {name} is not bit-equal to plain")
    log(f"    K10 {label}: kernel and walk model bit-equal to plain on every "
        "lane")
    return frac, err, rule


def needed_anyhit_tests(cs, o_t, d_t, tn, tx, occ, step=1 << 14):
    """Cluster tests an any-hit query needs, whatever the walk: one for
    each occluded lane (its occluder's cluster), and for each other lane
    every cluster whose box its segment [tmin, tmax] enters. Lanes with
    tmax = -inf need none."""
    live = tx > -torch.inf
    total = int((occ & live).sum())
    free = torch.nonzero(live & ~occ)[:, 0]
    for s in range(0, free.shape[0], step):
        lane = free[s:s + step]
        total += int(box_entered(o_t[:, lane].T[:, None], d_t[:, lane].T[:, None],
                                 tn[lane, None], tx[lane, None], cs.aabb_lo,
                                 cs.aabb_hi).sum())
    return total


def k10_launch(cs, label, args, closest, rule):
    """K10 timed on one launch's inputs, with its bound (the cluster tests
    its rays need) and its counts: needed tests, tests the warp rule runs
    (`rule`, from binned_round_warp) and the old per-block items. The
    plain version (4.6-9.3 s a call) is timed on one call, warm from the
    comparison before it (BINNED_PLAIN_REPS)."""
    from sunray_tpu_torch.ops import cuda_binned as cb

    order, ents, count, o_t, d_t, tn, tx = args[:7]
    k_tris = cs.tri_pack.shape[2]
    out = cb.binned_round(*args, closest=closest)
    needed = (needed_block_tests(cs, o_t, d_t, tn, tx, out[0]) if closest
              else needed_anyhit_tests(cs, o_t, d_t, tn, tx, out))
    items = int(count.sum())
    live = int((tx > -torch.inf).sum())
    r = dict(
        ms=device_ms(lambda: cb.binned_round(*args, closest=closest)),
        plain_ms=time_ms(lambda: cb.binned_round_plain(*args, closest=closest),
                         reps=BINNED_PLAIN_REPS, warm=0),
        bound=bound(o_t.shape[1] * 52 + cs.num_clusters * 10 * k_tris * 4
                    + nbytes(order, ents, count), needed * k_tris * TEST_OPS),
        needed_tests=needed, rule_tests=rule, block_items=items)
    log(f"  K10 {label}: {live} live lanes, {count.shape[0]} blocks; cluster "
        f"tests needed {needed} ({needed / max(live, 1):.3f} per live lane), run "
        f"by the warp rule {rule} ({rule / max(needed, 1):.2f}x needed); old "
        f"per-block items {items} ({items * cb.BLOCK_RAYS} lane tests, "
        f"{items * cb.BLOCK_RAYS / max(needed, 1):.2f}x needed); kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound'][0]:.4f} ms ({r['bound'][1]}, "
        f"{r['bound'][0] / r['ms']:.1%} of it)")
    return r


def pair_stream_checks(cs, label, orig, d, tmax, exclude, closest):
    """K11, K12 and the overflow fallback's K10 against their plain
    versions on one pair-stream query, prepared as trace_*_pairs prepares
    it. Returns (agreement of K10, of K12, K11 exact, overflow share,
    K11's, K12's and the fallback K10's inputs)."""
    from sunray_tpu_torch.ops import binned_trace as bt
    from sunray_tpu_torch.ops import cuda_binned as cb
    from sunray_tpu_torch.ops.intersect import T_MIN

    o_t, d_t, tn, tx, ex, _, _ = bt._prep(orig, d, T_MIN, tmax, exclude)
    box = bt.supercluster_boxes(cs)
    ks, kc = cb.cluster_scan(o_t, d_t, tn, tx, box)
    ps, pc = cb.cluster_scan_plain(o_t, d_t, tn, tx, box)
    torch.cuda.synchronize()
    exact = bool(torch.equal(ks, ps) and torch.equal(kc, pc))
    overflow = pc > cb.L_SLOTS
    over = overflow[tx > -torch.inf].float().mean().item()
    log(f"  K11 cluster_scan {label}: {o_t.shape[1]} lanes x {box.shape[0]} "
        f"superclusters, bit-exact {exact}; superclusters hit per ray: mean "
        f"{pc.float().mean().item():.3f}, max {int(pc.max())}; overflow "
        f"(> {cb.L_SLOTS}) share {over:.6f}")
    check(exact, f"K11 cluster_scan {label} differs from its plain version")

    cid_s, pos_s, runs, n_sc, overflow = bt._pair_stream_prep(cs, o_t, d_t, tn,
                                                              tx)
    live = int((cid_s < n_sc).sum())
    log(f"  K12 pair_round {label}: {cid_s.numel()} pair lanes, {live} live, "
        f"{int(runs.sum())} work items, {int((runs > 1).sum())} blocks with "
        "more than one supercluster")
    args = (cid_s, pos_s, runs, o_t, d_t, tn, tx, ex, cs, n_sc)
    k12 = compare_k12(args, closest, label)

    # The overflow rays through the block path, the others masked out.
    fb = block_args(cs, o_t.T, d_t.T, torch.where(overflow, tx, -torch.inf), ex)
    k10 = compare_k10(fb, closest, f"{label}, overflow fallback",
                      live=fb[6] > -torch.inf)
    return k10, k12, exact, over, (o_t, d_t, tn, tx, box), args, fb


def compare_k12(args, closest, label):
    """K12 against its plain version on one launch's inputs: every live pair
    position bit-equal, and so is the plain model of the kernel's walk
    (pair_round_warp). Returns (agreement, error, the model's count of the
    cluster tests the rule runs)."""
    from sunray_tpu_torch.ops import cuda_binned as cb

    cid_s, pos_s, n_sc = args[0], args[1], args[9]
    live = torch.zeros_like(cid_s, dtype=torch.bool)
    live[pos_s[cid_s < n_sc].long()] = True
    k = cb.pair_round(*args, closest=closest)
    p = cb.pair_round_plain(*args, closest=closest)
    model, rule = cb.pair_round_warp(*args, closest=closest)
    torch.cuda.synchronize()
    if closest:
        frac, err = compare_hits("K12", k, p, f"{label}, live pair lanes", live)
    else:
        frac, err = compare_occ("K12", k, p, f"{label}, live pair lanes", live), 0.0
    for name, out in (("kernel", k), ("walk model", model)):
        same = (all(torch.equal(a[live].view(torch.int32), b[live].view(torch.int32))
                    for a, b in zip(out, p)) if closest
                else torch.equal(out[live], p[live]))
        check(same, f"K12 {label}: the {name} is not bit-equal to plain")
    log(f"    K12 {label}: kernel and walk model bit-equal to plain on every "
        "live pair lane")
    return frac, err, rule


def k12_launch(cs, label, args, closest, rule):
    """K12 timed on one launch's inputs, with its bound (the cluster tests
    its pair lanes need) and its counts: needed tests, tests the warp rule
    runs (`rule`, from pair_round_warp) and the SC_K a live lane that an
    unculled kernel runs; and the same launch with every lane dead
    (no pair), the cost of the dead tail's blocks. The plain version is
    timed as k10_launch times K10's."""
    from sunray_tpu_torch.ops import cuda_binned as cb

    cid_s, pos_s, runs, o_t = args[:4]
    n_sc, k_tris = args[9], cs.tri_pack.shape[2]
    out = cb.pair_round(*args, closest=closest)
    needed = (needed_pair_tests(cs, args, t_pair=out[0]) if closest
              else needed_pair_tests(cs, args, occ=out))
    live_sc = cid_s[cid_s < n_sc].long()
    old = sum(int((live_sc * cb.SC_K + q < cs.num_clusters).sum())
              for q in range(cb.SC_K))
    dead = (torch.full_like(cid_s, n_sc), pos_s, torch.zeros_like(runs),
            *args[3:])
    out_bytes = cid_s.numel() * (16 if closest else 1)
    r = dict(
        ms=device_ms(lambda: cb.pair_round(*args, closest=closest)),
        dead_ms=device_ms(lambda: cb.pair_round(*dead, closest=closest)),
        plain_ms=time_ms(lambda: cb.pair_round_plain(*args, closest=closest),
                         reps=BINNED_PLAIN_REPS, warm=0),
        bound=bound(nbytes(cid_s, pos_s, runs) + o_t.shape[1] * 36
                    + cs.num_clusters * 10 * k_tris * 4 + out_bytes,
                    needed * k_tris * TEST_OPS),
        needed_tests=needed, rule_tests=rule, old_tests=old)
    log(f"  K12 {label}: {live_sc.numel()} live pair lanes of {cid_s.numel()}; "
        f"cluster tests needed {needed}, run by the warp rule {rule} "
        f"({rule / max(needed, 1):.2f}x needed), unculled {old} "
        f"({old / max(needed, 1):.2f}x); kernel {r['ms']:.4f} ms, dead lanes "
        f"alone {r['dead_ms']:.4f} ms ({r['dead_ms'] / r['ms']:.1%}), plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
        f"({r['bound'][1]}, {r['bound'][0] / r['ms']:.1%} of it)")
    return r


def phase_binned_kernels(dev):
    from sunray_tpu_torch.ops import cuda_binned as cb
    from sunray_tpu_torch.ops.intersect import T_MAX

    log("phase 6: K10-K12 against their plain versions (1080p big-mesh "
        "frame 2's rays)")
    cs, (co, cd), (go, gd), (vo, vd, vmax, vex) = capture_binned_rays(dev)
    results = {}

    # K10: the camera rays through the block path.
    args = block_args(cs, co, cd, T_MAX, None)
    count = args[2]
    f_cam, e_cam, rule = compare_k10(args, True, "camera")
    nb = count.shape[0]
    log(f"    {nb} blocks, {int(count.sum())} culled work items "
        f"({int(count.sum()) / (nb * cs.num_clusters):.4f} of all)")
    cam = k10_launch(cs, "camera", args, True, rule)

    # K11, K12 and the fallback: the GI bounce rays (closest) and the GI
    # taps' visibility rays with their exclude ids (any-hit), through the
    # pair stream as render/trace.py sends them.
    f10_b, f12_b, _, over, scan_in, pair_args, fb_b = pair_stream_checks(
        cs, "GI bounce", go, gd, T_MAX, None, closest=True)
    seg = torch.as_tensor(vmax, dtype=torch.float32, device=dev) - 1e-3
    f10_v, f12_v, _, over_v, _, pair_args_v, fb_v = pair_stream_checks(
        cs, "GI-tap visibility", vo, vd, seg, vex, closest=False)
    fb_close = k10_launch(cs, "GI bounce overflow fallback (closest)", fb_b,
                          True, f10_b[2])
    fb_any = k10_launch(cs, "GI-tap visibility overflow fallback (any-hit)",
                        fb_v, False, f10_v[2])

    # The kernels line's row: the camera launch, the fallbacks beside it.
    results["binned_round"] = dict(
        cam, agree=min(f_cam, f10_b[0], f10_v[0]),
        max_abs_err=max(e_cam, f10_b[1]),
        fallback_closest_ms=fb_close["ms"], fallback_anyhit_ms=fb_any["ms"],
        fallback_closest_bound_ms=fb_close["bound"][0],
        fallback_anyhit_bound_ms=fb_any["bound"][0])
    lanes, n_box = scan_in[0].shape[1], scan_in[4].shape[0]
    results["cluster_scan"] = dict(
        max_abs_err=0.0, overflow_share=over,
        ms=device_ms(lambda: cb.cluster_scan(*scan_in)),
        plain_ms=time_ms(lambda: cb.cluster_scan_plain(*scan_in)),
        bound=bound(lanes * (32 + 36) + nbytes(scan_in[4]),
                    lanes * n_box * SLAB_OPS),
        # None of the slab test's operations is a fused multiply-add, so the
        # card issues them at half the rate that counts an FMA as two.
        nonfma_floor_ms=lanes * n_box * SLAB_OPS / (FP32_OPS_S / 2) * 1e3)
    log(f"  K11 GI bounce: non-FMA floor "
        f"{results['cluster_scan']['nonfma_floor_ms']:.4f} ms")
    k12_close = k12_launch(cs, "GI bounce (closest)", pair_args, True,
                           f12_b[2])
    k12_any = k12_launch(cs, "GI-tap visibility (any-hit)", pair_args_v, False,
                         f12_v[2])
    log(f"  overflow share GI bounce {over:.6f}, GI-tap visibility {over_v:.6f}")
    results["pair_round"] = dict(
        k12_close, agree=min(f12_b[0], f12_v[0]), max_abs_err=f12_b[1],
        anyhit_ms=k12_any["ms"], anyhit_bound_ms=k12_any["bound"][0],
        anyhit_plain_ms=k12_any["plain_ms"], anyhit_dead_ms=k12_any["dead_ms"],
        anyhit_needed_tests=k12_any["needed_tests"],
        anyhit_rule_tests=k12_any["rule_tests"],
        anyhit_old_tests=k12_any["old_tests"])
    for name, r in results.items():
        log(f"  time {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
    return results


def phase_big_small(dev):
    """The small big-mesh config on the card and on the CPU."""
    from sunray_tpu_torch.config import RenderConfig

    log(f"phase 6: small big-mesh config (subdiv {SMALL_BIG_SUBDIV}, "
        f"cluster_k {SMALL_BIG['cluster_k']}, {SMALL_BIG_FRAMES} frames), "
        "card vs CPU")
    cfg = RenderConfig(**SMALL_BIG)
    gpu = render(cfg, dev, SMALL_BIG_FRAMES, SMALL_BIG_SUBDIV).cpu().numpy()
    cpu = render(cfg, "cpu", SMALL_BIG_FRAMES, SMALL_BIG_SUBDIV).numpy()
    p = psnr(gpu, cpu)
    log(f"  PSNR card vs CPU {p:.2f} dB")
    check(p > PSNR_MIN, f"small big-mesh: card vs CPU PSNR {p:.2f} dB")


def phase_big_vs_brute(dev, width=480, height=270):
    """One big-mesh frame through the binned tracer and through
    tracer="brute" (K1/K2 over every triangle)."""
    from sunray_tpu_torch.config import RenderConfig

    log(f"phase 6: {width}x{height} big-mesh frame, binned vs brute")
    binned = render(RenderConfig(width=width, height=height), dev, 1,
                    BIG_SUBDIV).cpu().numpy()
    t0 = time.perf_counter()
    brute = render(RenderConfig(width=width, height=height, tracer="brute"),
                   dev, 1, BIG_SUBDIV, binned=False).cpu().numpy()
    p = psnr(binned, brute)
    log(f"  PSNR binned vs brute {p:.2f} dB (brute frame "
        f"{time.perf_counter() - t0:.1f} s)")
    check(p > PSNR_MIN, f"big-mesh binned vs brute PSNR {p:.2f} dB")


# -- phases 4 and 5: frames --------------------------------------------------

def big_scene(device, subdiv=BIG_SUBDIV):
    """tests/torch_big_scene.py's Cornell box + mirror icosphere."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_big_scene import big_scene_args

    from sunray_tpu_torch.scene.types import MaterialTable, build_scene

    args = big_scene_args(subdiv)
    return build_scene(**dict(args, device=device, materials=MaterialTable.build(
        args["materials"], device)))


def big_accel(scene, cfg):
    """The load-time ClusterSet, as the JAX Renderer builds it
    (renderer.py:114-117)."""
    from sunray_tpu_torch.ops import binned_trace

    return binned_trace.build_cluster_set(scene.world_triangle_vertices(),
                                          k=cfg.cluster_k)


def render(cfg, device, frames, subdiv=None, binned=True):
    """ldr after `frames` frames of the Cornell box, or of the big-mesh
    scene at `subdiv`, through its ClusterSet unless binned=False."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    if subdiv is None:
        scene, accel = cornell_box(device=device), None
    else:
        scene = big_scene(device, subdiv)
        accel = big_accel(scene, cfg) if binned else None
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height, device=device)
    state = RenderState.create(cfg, device)
    ldr = None
    for _ in range(frames):
        state, ldr, _ = render_frame(scene, cfg, state, mats, accel)
    return ldr


def phase_golden(dev):
    from sunray_tpu_torch.config import RenderConfig

    out = {}
    for lighting, frames in GOLDEN_FRAMES.items():
        log(f"phase 4: golden {lighting} config, {frames} frames, card vs CPU")
        cfg = RenderConfig(**dict(GOLDEN_KW, lighting=lighting))
        gpu = render(cfg, dev, frames).cpu().numpy()
        cpu = render(cfg, "cpu", frames).numpy()
        p_cc = psnr(gpu, cpu)
        golden = np.load(os.path.join(REPO, "tests", "goldens",
                                      f"cornell_{lighting}.npy"))
        p_g = psnr(gpu, golden)
        log(f"  PSNR card vs CPU {p_cc:.2f} dB, card vs golden {p_g:.2f} dB")
        check(p_cc > PSNR_MIN, f"{lighting}: card vs CPU PSNR {p_cc:.2f} dB")
        check(p_g > PSNR_MIN, f"{lighting}: card vs golden PSNR {p_g:.2f} dB")
        out[lighting] = (p_cc, p_g)
    log(f"phase 4: golden restir config with the kernel switches, "
        f"{SWITCH_FRAMES} frames, card vs CPU")
    cfg = RenderConfig(**dict(GOLDEN_KW, lighting="restir", **SWITCHES))
    gpu = render(cfg, dev, SWITCH_FRAMES).cpu().numpy()
    cpu = render(cfg, "cpu", SWITCH_FRAMES).numpy()
    p_cc = psnr(gpu, cpu)
    log(f"  PSNR card vs CPU {p_cc:.2f} dB")
    check(p_cc > PSNR_MIN, f"switches: card vs CPU PSNR {p_cc:.2f} dB")
    out["switches"] = (p_cc, None)
    denoise_switch(dev)
    return out


def denoise_switch(dev, frames=2):
    """The golden ReSTIR config with denoise_kernel "auto" and "jnp" on the
    card: "auto" launches K7 once per pass, "jnp" never (the plain passes),
    and the two agree (K7 is within 1e-5 of plain)."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build

    log(f"phase 4: denoise_kernel 'auto' and 'jnp', golden restir config, "
        f"{frames} frames on the card")
    ldr = {}
    for kernel in ("auto", "jnp"):
        cfg = RenderConfig(**dict(GOLDEN_KW, lighting="restir",
                                  denoise_kernel=kernel))
        cuda_build.launches.clear()
        ldr[kernel] = render(cfg, dev, frames).cpu().numpy()
        k7 = cuda_build.launches["atrous_pass"]
        want = 0 if kernel == "jnp" else cfg.denoise_passes * frames
        log(f"  denoise_kernel {kernel!r}: K7 launched {k7} times")
        check(k7 == want, f"denoise_kernel {kernel!r}: K7 launched {k7} "
              f"times, expected {want}")
    p = psnr(ldr["auto"], ldr["jnp"])
    log(f"  PSNR 'auto' vs 'jnp' {p:.2f} dB")
    check(p > PSNR_MIN, f"denoise_kernel auto vs jnp PSNR {p:.2f} dB")


def rays_expected(cfg, aux):
    """bench.py:7-13: P * (ris_rounds + 3 + final_rounds - 1 + 2 + T_gi)."""
    return cfg.width * cfg.height * (aux["ris_rounds"] + 3
                                     + aux["final_rounds"] - 1 + 2
                                     + cfg.gi_spatial_samples)


def phase_main(dev, lighting, kernels, n_warm, n_timed, width=1920,
               height=1080, big=False, switches=None, absent=(), record=None):
    """One slice's main path: the frame at width x height, counters zeroed
    before the warm-up and read after the timed frames. switches: config
    overrides (the kernel-switches slice, phase 7); absent: kernels that
    must not launch; record: a dict that receives the frame ms and the
    last frame's walk rounds (phase 13's roofline)."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build, cuda_trace
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    cfg = RenderConfig(width=width, height=height, lighting=lighting,
                       **(switches or {}))
    if switches:
        log(f"phase 7: {width}x{height} Cornell frame, lighting={lighting!r}, "
            f"switches {switches}")
        scene, accel = cornell_box(device=dev), None
    elif big:
        log(f"phase 6: {width}x{height} big-mesh frame, lighting={lighting!r}")
        scene = big_scene(dev)
        accel = big_accel(scene, cfg)
        log(f"  {scene.num_tris} triangles, {accel.num_clusters} clusters of "
            f"{cfg.cluster_k}")
    else:
        log(f"phase 5: {width}x{height} Cornell frame, lighting={lighting!r}")
        scene, accel = cornell_box(device=dev), None
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height, device=dev)
    state = RenderState.create(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    cuda_build.launches.clear()
    cuda_trace.rays.clear()
    t0 = time.perf_counter()
    for _ in range(n_warm):
        state, ldr, aux = render_frame(scene, cfg, state, mats, accel)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rays0 = sum(cuda_trace.rays.values())
    expected = 0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, ldr, aux = render_frame(scene, cfg, state, mats, accel)
        expected += rays_expected(cfg, aux) if lighting == "restir" else 0
    torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / n_timed
    launches = dict(cuda_build.launches)
    rays_per_frame = (sum(cuda_trace.rays.values()) - rays0) / n_timed

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ldr_np = ldr.cpu().numpy()
    mean = float(ldr_np.mean())
    log(f"  warm-up {n_warm} frames {warm_s:.3f} s; frame {frame_s * 1e3:.3f} ms "
        f"(mean of {n_timed}); rays/frame {rays_per_frame:.0f} "
        f"({rays_per_frame / frame_s / 1e6:.2f} Mray/s); walk rounds "
        f"ris {aux['ris_rounds']} final {aux['final_rounds']}; "
        f"peak memory {peak_gb:.3f} GB; ldr mean {mean:.4f}")
    log(f"  launches over {n_warm + n_timed} frames: {launches}")
    check(ldr_np.shape == (height, width, 3), f"ldr shape {ldr_np.shape}")
    check(bool(np.isfinite(ldr_np).all()), "non-finite ldr")
    check(0.05 < mean < 0.95, f"ldr mean {mean}")
    if lighting == "restir":
        check(rays_per_frame * n_timed == expected,
              f"rays/frame {rays_per_frame} != bench.py's count "
              f"{expected / n_timed}")
    for name in kernels:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched")
    for name in absent:
        check(launches.get(name, 0) == 0, f"kernel {name} launched")
    if record is not None:
        record.update(frame_ms=frame_s * 1e3, ris_rounds=aux["ris_rounds"],
                      final_rounds=aux["final_rounds"])
    stage_breakdown(scene, cfg, state, mats, frame_s, accel)
    if big:
        profile_frame(scene, cfg, state, mats, accel)
    if switches:
        history_select_bit_equal(scene, cfg, mats, dev)
    return launches


def history_select_bit_equal(scene, cfg, mats, dev, frames=3):
    """The frame with history_select_kernel "auto" (K13) and "off" (plain
    indexing) from a fresh state: ldr bit-equal."""
    import dataclasses

    from sunray_tpu_torch.render.pipeline import RenderState, render_frame

    ldrs = []
    for select in ("auto", "off"):
        c = dataclasses.replace(cfg, history_select_kernel=select)
        state = RenderState.create(c, dev)
        for _ in range(frames):
            state, ldr, _ = render_frame(scene, c, state, mats)
        ldrs.append(ldr)
    torch.cuda.synchronize()
    same = torch.equal(ldrs[0], ldrs[1])
    log(f"  history_select_kernel auto vs off, {frames} frames: ldr bit-equal "
        f"{same}")
    check(same, "history_select_kernel auto and off frames differ")


def profile_frame(scene, cfg, state, mats, accel, rows=12):
    """Device time of one frame by kernel (torch.profiler), grouped into
    the port's kernels, sorts and the rest of PyTorch, and the `rows`
    kernels that took the most."""
    from torch.profiler import ProfilerActivity, profile

    from sunray_tpu_torch.render.pipeline import render_frame

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_frame(scene, cfg, state, mats, accel)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    ours = ("binned_kernel", "scan_kernel", "pair_kernel", "closest_kernel",
            "occluded_kernel", "gather_rows_kernel", "atrous_kernel",
            "ris_audition_kernel", "di_temporal_kernel", "di_spatial_kernel",
            "gi_spatial_kernel", "taa_kernel", "history_gather_kernel",
            "occluded_woop_kernel", "bvh_walk_kernel")
    stages = ("ris_pass", "final_pass", "taa", "denoise", "postprocess")
    groups = {"port kernels": 0.0, "sort": 0.0, "other PyTorch": 0.0}
    kernels = [e for e in events
               if "CUDA" in str(getattr(e, "device_type", "")) and dev_us(e) > 0
               and e.key not in stages]
    for e in kernels:
        key = e.key.lower()
        if any(k in key for k in ours):
            groups["port kernels"] += dev_us(e)
        elif "sort" in key or "radix" in key:
            groups["sort"] += dev_us(e)
        else:
            groups["other PyTorch"] += dev_us(e)
    total = sum(groups.values())
    if total <= 0:
        log("  profile: no device time recorded (not measured)")
        return
    log("  profiled frame, device time: " + ", ".join(
        f"{k} {v / 1e3:.3f} ms ({v / total:.1%})" for k, v in groups.items())
        + f"; {total / 1e3:.3f} ms busy of {wall_ms:.3f} ms wall (idle "
        f"{max(0.0, 1.0 - total / 1e3 / wall_ms):.1%}, profiler on)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:rows]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms {e.count:5d}x  {e.key[:70]}")
    for kid, kernel in (("K10", "binned_kernel"), ("K12", "pair_kernel")):
        walk = sorted((e for e in prof.events() if kernel in e.name
                       and "CUDA" in str(getattr(e, "device_type", ""))),
                      key=lambda e: e.time_range.start)
        log(f"  {kid} by launch, device ms, in frame order: " + ", ".join(
            f"{'closest' if '<true>' in e.name else 'any-hit'} "
            f"{e.time_range.elapsed_us() / 1e3:.3f}" for e in walk)
            + f"; {len(walk)} launches, "
            f"{sum(e.time_range.elapsed_us() for e in walk) / 1e3:.3f} ms")


def stage_breakdown(scene, cfg, state, mats, frame_s, accel=None, frames=3):
    """Host-clock ms per frame of each stage of render_frame, the device
    synchronised at each stage's start and end. render_frame's profiler
    ranges are swapped for synchronising timers for these frames only, so
    the stages measured are the ones the timed frames ran."""
    import collections
    import contextlib

    from sunray_tpu_torch.render import pipeline

    totals = collections.Counter()

    @contextlib.contextmanager
    def timed(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t0

    profiler_range = pipeline.record_function
    pipeline.record_function = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        state, _, _ = pipeline.render_frame(scene, cfg, state, mats, accel)
    torch.cuda.synchronize()
    total_s = (time.perf_counter() - t0) / frames
    pipeline.record_function = profiler_range
    parts = ", ".join(f"{k} {v / frames * 1e3:.3f}" for k, v in totals.items())
    other = total_s - sum(totals.values()) / frames
    log(f"  stages, synced, ms/frame (mean of {frames}): {parts}, "
        f"outside the stages {other * 1e3:.3f}; synced frame "
        f"{total_s * 1e3:.3f} vs unsynced {frame_s * 1e3:.3f}")


KERNELS = {
    "trace_closest": ("sunray_tpu_torch/csrc/trace.cu",
                      "sunray_tpu/ops/pallas_trace.py:288"),
    "trace_occluded": ("sunray_tpu_torch/csrc/trace.cu",
                       "sunray_tpu/ops/pallas_trace.py:380"),
    "gather_rows": ("sunray_tpu_torch/csrc/gather.cu",
                    "sunray_tpu/ops/pallas_gather.py:212"),
    "gather_rows_multi": ("sunray_tpu_torch/csrc/gather.cu",
                          "sunray_tpu/ops/pallas_gather.py:193"),
    "atrous_pass": ("sunray_tpu_torch/csrc/atrous.cu",
                    "sunray_tpu/ops/pallas_image.py:258"),
    "ris_audition": ("sunray_tpu_torch/csrc/restir.cu",
                     "sunray_tpu/ops/pallas_restir.py:291"),
    "di_temporal": ("sunray_tpu_torch/csrc/restir.cu",
                    "sunray_tpu/ops/pallas_restir.py:1044"),
    "di_spatial": ("sunray_tpu_torch/csrc/restir.cu",
                   "sunray_tpu/ops/pallas_restir.py:566"),
    "gi_spatial": ("sunray_tpu_torch/csrc/restir.cu",
                   "sunray_tpu/ops/pallas_restir.py:791"),
    "binned_round": ("sunray_tpu_torch/csrc/binned.cu",
                     "sunray_tpu/ops/binned_trace.py:546"),
    "cluster_scan": ("sunray_tpu_torch/csrc/binned.cu",
                     "sunray_tpu/ops/binned_trace.py:752"),
    "pair_round": ("sunray_tpu_torch/csrc/binned.cu",
                   "sunray_tpu/ops/binned_trace.py:962"),
    "taa_clamp_blend": ("sunray_tpu_torch/csrc/taa.cu",
                        "sunray_tpu/ops/pallas_image.py:390"),
    "history_gather": ("sunray_tpu_torch/csrc/history.cu",
                       "sunray_tpu/ops/pallas_window.py:139"),
    "trace_occluded_woop": ("sunray_tpu_torch/csrc/trace.cu",
                            "sunray_tpu/ops/pallas_trace.py:329"),
    "gather_rows_bwd": ("sunray_tpu_torch/csrc/gather.cu",
                        "sunray_tpu/ops/pallas_gather.py:178"),
    # K8's backward above 512 rows: the reference's gathers of such tables
    # are plain indexing (no pallas_call; ops/linalg.py:27), whose
    # transpose is a scatter-add.
    "gather_rows_bwd_runs": ("sunray_tpu_torch/csrc/gather.cu",
                             "sunray_tpu/ops/linalg.py:27"),
    # B1 replaces a jnp stage (no pallas_call): the candidate extraction
    # loop and _candidate_score of the shadow-boundary term.
    "boundary_candidates": ("sunray_tpu_torch/csrc/boundary.cu",
                            "sunray_tpu/render/boundary.py:205"),
    # B2 and B3 replace jnp stack walks (lax.while_loop, no pallas_call).
    "bvh_walk": ("sunray_tpu_torch/csrc/bvh.cu", "sunray_tpu/ops/bvh.py:375"),
    "bvh2_walk": ("sunray_tpu_torch/csrc/bvh.cu",
                  "sunray_tpu/ops/bvh2.py:454"),
    # R1 replaces a jnp lax.scan (no pallas_call): rasterize_mesh and
    # paint_meshes of the 2D overlay painter.
    "paint_meshes": ("sunray_tpu_torch/csrc/overlay.cu",
                     "sunray_tpu/render/overlay2d.py:79"),
    # The window forms of K5, K7 and K9 that the row-sharded frame runs
    # (phase 15): a band's lanes, neighbours read in a halo window.
    "di_spatial_window": ("sunray_tpu_torch/csrc/restir.cu",
                          "sunray_tpu/ops/pallas_restir.py:566"),
    "atrous_pass_window": ("sunray_tpu_torch/csrc/atrous.cu",
                           "sunray_tpu/ops/pallas_image.py:258"),
    "taa_clamp_blend_window": ("sunray_tpu_torch/csrc/taa.cu",
                               "sunray_tpu/ops/pallas_image.py:390"),
}
BINNED_KERNELS = ("binned_round", "cluster_scan", "pair_round")
SWITCH_KERNELS = ("taa_clamp_blend", "history_gather", "trace_occluded_woop")
# The differentiable slice's own kernel: K8's backward.
DIFF_ONLY = ("gather_rows_bwd",)
# The visibility gradients' own kernel: B1.
VIS_ONLY = ("boundary_candidates",)
# The real scene's own kernels (phase 10): B2 and B3.
REAL_ONLY = ("bvh_walk", "bvh2_walk")
# The differentiable real scenes' own kernel (phase 11): K8's backward
# above 512 rows.
RUNS_ONLY = ("gather_rows_bwd_runs",)
# The interactive path's own kernel (phase 14): R1, on hud_overlay's path.
OVERLAY_ONLY = ("paint_meshes",)
# The row-sharded frame's own instantiations (phase 15).
PARALLEL_ONLY = ("di_spatial_window", "atrous_pass_window",
                 "taa_clamp_blend_window")
CORNELL_KERNELS = tuple(k for k in KERNELS
                        if k not in BINNED_KERNELS + SWITCH_KERNELS + DIFF_ONLY
                        + VIS_ONLY + REAL_ONLY + RUNS_ONLY + OVERLAY_ONLY
                        + PARALLEL_ONLY)
# A differentiable frame: the tracer and K8 forward and backward; the plain
# versions of K3-K7, K9 and K13 (JAX's gates).
DIFF_KERNELS = ("trace_closest", "trace_occluded", "gather_rows",
                "gather_rows_multi", "gather_rows_bwd")
DIFF_ABSENT = ("ris_audition", "di_temporal", "di_spatial", "gi_spatial",
               "atrous_pass", "taa_clamp_blend", "history_gather")
VIS_KERNELS = DIFF_KERNELS + VIS_ONLY
NEE_KERNELS = ("trace_closest", "trace_occluded", "gather_rows",
               "gather_rows_multi", "atrous_pass")
# The switches frame: K14 takes every occlusion query, so K2 stays idle.
SLICE_KERNELS = SWITCH_KERNELS + tuple(k for k in CORNELL_KERNELS
                                       if k != "trace_occluded")
# The big-mesh frame: every query goes through the binned tracer.
BIG_KERNELS = BINNED_KERNELS + tuple(k for k in CORNELL_KERNELS
                                     if k not in ("trace_closest",
                                                  "trace_occluded"))
# -- phase 8: the differentiable slice ----------------------------------------

def diff_setup(dev, width, height, **kw):
    """The differentiable Cornell frame of bench.py:128-190: config, scene
    with base_color and positions as leaves that require grad, matrices."""
    import dataclasses

    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render import boundary
    from sunray_tpu_torch.scene import cornell_box

    cfg = RenderConfig(width=width, height=height, differentiable=True, **kw)
    # The edge topology is read only with shadow_boundary_grads on.
    scene = boundary.with_edge_topology(cornell_box(device=dev))
    leaves = (scene.materials.base_color.clone().requires_grad_(),
              scene.positions.clone().requires_grad_())
    scene = dataclasses.replace(
        scene, positions=leaves[1],
        materials=dataclasses.replace(scene.materials, base_color=leaves[0]))
    mats = camera_matrices(Camera(**CAMERA), width, height, device=dev)
    return cfg, scene, leaves, mats


def diff_step(cfg, scene, leaves, mats, state):
    """One training step's render: mean(ldr) and its gradients w.r.t.
    base_color and positions; the next state. Returns (state, loss, (g_base_color, g_positions), aux)."""
    from sunray_tpu_torch.render.pipeline import render_frame

    state, ldr, aux = render_frame(scene, cfg, state, mats)
    loss = ldr.mean()
    grads = torch.autograd.grad(loss, leaves)
    return state, loss.detach(), grads, aux


def diff_run(dev, steps, width, height, **kw):
    """[(loss, grads)] of `steps` steps from a fresh state."""
    from sunray_tpu_torch.render.pipeline import RenderState

    cfg, scene, leaves, mats = diff_setup(dev, width, height, **kw)
    state = RenderState.create(cfg, dev)
    out = []
    for _ in range(steps):
        state, loss, grads, _ = diff_step(cfg, scene, leaves, mats, state)
        out.append((loss.cpu(), [g.cpu() for g in grads]))
    return out


def grads_close(got, want):
    """Elementwise within DIFF_GRAD_RTOL, with a floor of DIFF_GRAD_FLOOR
    of the largest |want|; returns (ok, largest difference over that
    largest |want|)."""
    atol = DIFF_GRAD_FLOOR * float(want.abs().max())
    ok = bool(torch.allclose(got, want, rtol=DIFF_GRAD_RTOL, atol=atol))
    return ok, float((got - want).abs().max() / want.abs().max())


def diff_card_vs_cpu(dev, phase=8, **extra):
    """The differentiable frame (ReSTIR unless `extra` says otherwise) at
    the golden size, DIFF_STEPS steps with the state threaded, on the card
    and on the CPU."""
    kw = {k: v for k, v in GOLDEN_KW.items() if k not in ("width", "height",
                                                         "lighting")}
    kw.update(extra)
    size = (GOLDEN_KW["width"], GOLDEN_KW["height"])
    log(f"phase {phase}: differentiable frame {size[0]}x{size[1]} "
        f"{extra or '(ReSTIR)'}, {DIFF_STEPS} steps, card vs CPU")
    card = diff_run(dev, DIFF_STEPS, *size, **kw)
    cpu = diff_run("cpu", DIFF_STEPS, *size, **kw)
    for i, ((lg, gg), (lc, gc)) in enumerate(zip(card, cpu)):
        rel = abs(float(lg) - float(lc)) / abs(float(lc))
        checks = [grads_close(a, b) for a, b in zip(gg, gc)]
        log(f"  step {i}: loss card {float(lg):.7f} CPU {float(lc):.7f} "
            f"(rel {rel:.2e}); gradient max diff / max |g|: base_color "
            f"{checks[0][1]:.2e}, positions {checks[1][1]:.2e}; |positions "
            f"grad| on the card {float(gg[1].norm()):.6f}")
        check(rel <= DIFF_LOSS_RTOL, f"step {i}: card vs CPU loss rel {rel}")
        for name, (ok, _) in zip(("base_color", "positions"), checks):
            check(ok, f"step {i}: {name} gradient card vs CPU")
        check(float(gg[1].abs().max()) > 0.0,
              f"step {i}: zero positions gradient on the card")


def capture_bwd_calls(fn):
    """fn() with cuda_gather.gather_rows_bwd recording its arguments:
    returns (fn's result, [(ct, idx, k), ...])."""
    from sunray_tpu_torch.ops import cuda_gather

    calls, inner = [], cuda_gather.gather_rows_bwd

    def recording(ct, idx, k):
        calls.append((ct.clone(), idx.clone(), k))
        return inner(ct, idx, k)

    cuda_gather.gather_rows_bwd = recording
    try:
        return fn(), calls
    finally:
        cuda_gather.gather_rows_bwd = inner


def k8_bwd_hold(labelled):
    """K8's backward (either path: the shared-memory kernel up to MAX_ROWS
    rows, the runs path above) against its plain version on each (label,
    (ct, idx, k)). On the entries where the float64 sums are finite:
    errors over each table row's sum of |ct| against them (at most
    K8_BWD_TOL) and against plain's float32 sums (at most
    K8_BWD_PLAIN_TOL). NaN exactly where the float64 sums are NaN (a NaN
    cotangent, the reference's, reaches the table); two runs bit-equal as
    int32 words. One line a label, over its calls. Returns the worst of
    each (float64, plain, absolute against plain) and whether every call
    passed the last two checks."""
    import collections

    from sunray_tpu_torch.ops import cuda_gather

    per = collections.defaultdict(lambda: dict(
        n=0, err=0.0, err_plain=0.0, plain_own=0.0, abs_err=0.0, same=True,
        nan=0, shapes=set()))
    for label, (ct, idx, k) in labelled:
        got = cuda_gather.gather_rows_bwd(ct, idx, k)
        again = cuda_gather.gather_rows_bwd(ct, idx, k)
        want = cuda_gather.gather_rows_bwd_plain(ct, idx, k)
        exact64 = cuda_gather.gather_rows_bwd_plain(ct.double(), idx, k)
        scale = cuda_gather.gather_rows_bwd_plain(ct.abs().double(), idx,
                                                  k).clamp(min=1e-30)
        torch.cuda.synchronize()
        fin = torch.isfinite(exact64)

        def worst_of(x):
            return float(x[fin].max()) if bool(fin.any()) else 0.0

        e = per[label]
        e["n"] += 1
        e["err"] = max(e["err"], worst_of((got - exact64).abs() / scale))
        e["err_plain"] = max(e["err_plain"],
                             worst_of((got - want).abs() / scale))
        e["plain_own"] = max(e["plain_own"],
                             worst_of((want - exact64).abs() / scale))
        e["abs_err"] = max(e["abs_err"], worst_of((got - want).abs()))
        e["same"] = (e["same"]
                     and torch.equal(got.view(torch.int32),
                                     again.view(torch.int32))
                     and torch.equal(torch.isnan(got), torch.isnan(exact64)))
        e["nan"] += int((~fin).sum())
        e["shapes"].add(f"{tuple(idx.shape)} indices into {k} x {ct.shape[1]}")
    for label, e in per.items():
        log(f"  K8 backward, {label}: {e['n']} call(s) of "
            f"{' / '.join(sorted(e['shapes']))}; over each row's sum |ct|: "
            f"against the float64 sums {e['err']:.2e}, against plain "
            f"(float32) {e['err_plain']:.2e}, plain against float64 "
            f"{e['plain_own']:.2e}; max abs err against plain "
            f"{e['abs_err']:.3e}; NaN entries {e['nan']}, where the float64 "
            f"sums have them; two runs bit-equal {e['same']}")
    worst = max(e["err"] for e in per.values())
    worst_plain = max(e["err_plain"] for e in per.values())
    worst_abs = max(e["abs_err"] for e in per.values())
    exact = all(e["same"] for e in per.values())
    check(worst <= K8_BWD_TOL, f"K8 backward error {worst} > {K8_BWD_TOL} "
          "against the float64 sums")
    check(worst_plain <= K8_BWD_PLAIN_TOL, f"K8 backward error {worst_plain}"
          f" > {K8_BWD_PLAIN_TOL} against plain")
    check(exact, "K8 backward: two runs differ, or NaN where the float64 "
          "sums are finite")
    return worst, worst_plain, worst_abs, exact


def bwd_call_kind(call):
    """Which gather of the 720p step a K8-backward call (ct, idx, k) comes
    from, by its shape: the vertex corners (3 index vectors into 72 x 6),
    the material rows (1 into 4 x 12), or else a visibility term's
    (edge AA's vertices, the boundary term's edge endpoints)."""
    ct, idx, k = call
    if (idx.shape[0], k, ct.shape[1]) == (3, 72, 6):
        return "corners"
    if (idx.shape[0], k, ct.shape[1]) == (1, 4, 12):
        return "materials"
    return "visibility"


def k8_bwd_vis_calls(calls):
    """The 720p step with both terms: K8's backward against its plain
    version on each of its calls, the visibility terms' own (bwd_call_kind)
    each timed beside its bound (ct and idx read once, the table written
    once). Returns [{shape, ms, bound_ms}] of the visibility calls."""
    from sunray_tpu_torch.ops import cuda_gather

    k8_bwd_hold([(f"step with both terms, call {i} ({bwd_call_kind(c)})", c)
                 for i, c in enumerate(calls)])
    out = []
    for ct, idx, k in (c for c in calls if bwd_call_kind(c) == "visibility"):
        entry = dict(
            shape=[list(idx.shape), k, ct.shape[1]],
            ms=device_ms(lambda: cuda_gather.gather_rows_bwd(ct, idx, k)),
            bound_ms=bound(nbytes(ct, idx) + k * ct.shape[1] * 4, 0)[0])
        log(f"  K8 backward, visibility call {tuple(idx.shape)} into {k} x "
            f"{ct.shape[1]}: {entry['ms']:.4f} ms, bound "
            f"{entry['bound_ms']:.4f} ms")
        out.append(entry)
    return out


def k8_bwd_row(calls, gen, dev):
    """K8's backward against its plain version on the 720p step's own
    cotangents and on 3 x 2,073,600 synthetic indices with out-of-range
    ones (errors over each table row's sum of |ct|; two runs bit-equal);
    timed on the step's first call beside index_add_ alone and its bound
    (ct and idx read once, the table written once)."""
    from sunray_tpu_torch.ops import cuda_gather

    n = 1920 * 1080
    synth = (torch.randn((3, 6, n), generator=gen, device=dev),
             torch.randint(-8, 80, (3, n), generator=gen, device=dev,
                           dtype=torch.int32), 72)
    worst, worst_plain, worst_abs, exact = k8_bwd_hold(
        [(f"step call {i}", c) for i, c in enumerate(calls)]
        + [("synthetic", synth)])
    # The row: the step's first corner call (3 x 921,600 into 72 x 6), the
    # TPU kernel's multi-index backward; its material fetches beside it.
    ct, idx, k = next(call for call in calls if call[1].shape[0] == 3)
    materials = next(call for call in calls if call[1].shape[0] == 1)
    c = ct.shape[1]
    rows = ct.permute(0, 2, 1).reshape(-1, c).contiguous()
    cidx = idx.long().clamp(0, k - 1).reshape(-1)
    dtab = torch.zeros((k, c), dtype=torch.float32, device=dev)
    row = dict(
        max_abs_err=worst_abs, err_over_row_abs_sum=worst,
        err_over_row_abs_sum_vs_plain=worst_plain, bit_equal_runs=exact,
        ms=device_ms(lambda: cuda_gather.gather_rows_bwd(ct, idx, k)),
        plain_ms=time_ms(lambda: cuda_gather.gather_rows_bwd_plain(ct, idx,
                                                                   k)),
        library_ms=device_ms(lambda: dtab.zero_().index_add_(0, cidx, rows)),
        bound=bound(nbytes(ct, idx) + k * c * 4, 0),
        shape=[list(idx.shape), k, c],
        synthetic_ms=device_ms(lambda: cuda_gather.gather_rows_bwd(*synth)),
        materials_ms=device_ms(lambda: cuda_gather.gather_rows_bwd(
            *materials)),
        materials_bound_ms=bound(nbytes(*materials[:2])
                                 + materials[2] * materials[0].shape[1] * 4,
                                 0)[0])
    log(f"  K8 backward at {tuple(idx.shape)}: kernel {row['ms']:.4f} ms, "
        f"index_add_ {row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} "
        f"ms, bound {row['bound'][0]:.4f} ms ({row['bound'][1]}); "
        f"3 x {n}: {row['synthetic_ms']:.4f} ms; material rows "
        f"{tuple(materials[1].shape)} into {materials[2]} x "
        f"{materials[0].shape[1]}: {row['materials_ms']:.4f} ms, bound "
        f"{row['materials_bound_ms']:.4f} ms")
    return row


def diff_stage_breakdown(cfg, scene, leaves, mats, state, steps=2):
    """Synced host ms of each forward stage of the differentiable step,
    and of its backward."""
    import collections
    import contextlib

    from sunray_tpu_torch.render import pipeline

    totals = collections.Counter()

    @contextlib.contextmanager
    def timed(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t0

    profiler_range = pipeline.record_function
    pipeline.record_function = timed
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, ldr, _ = pipeline.render_frame(scene, cfg, state, mats)
            loss = ldr.mean()
            torch.cuda.synchronize()
            totals["forward"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            totals["backward"] += time.perf_counter() - t0
    finally:
        pipeline.record_function = profiler_range
    log("  step stages, synced, ms/step: " + ", ".join(
        f"{k} {v / steps * 1e3:.3f}" for k, v in totals.items()))
    return {k: v / steps * 1e3 for k, v in totals.items()}


def diff_checkpoints_off(dev):
    """One step at DIFF_OFF_SIZE with the stage checkpoints on and off
    (ops/loops.checkpoint made a plain call): peak memory and step time
    of each, and the gradients' largest difference."""
    from sunray_tpu_torch.ops import loops
    from sunray_tpu_torch.render.pipeline import RenderState

    out = {}
    inner = loops.checkpoint
    for mode in ("on", "off"):
        if mode == "off":
            loops.checkpoint = lambda fn, *args, **kw: fn(*args)
        try:
            cfg, scene, leaves, mats = diff_setup(dev, *DIFF_OFF_SIZE)
            state = RenderState.create(cfg, dev)
            state, _, _, _ = diff_step(cfg, scene, leaves, mats, state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            _, loss, grads, _ = diff_step(cfg, scene, leaves, mats, state)
            torch.cuda.synchronize()
            out[mode] = ((time.perf_counter() - t0) * 1e3,
                         (torch.cuda.max_memory_allocated() - base) / 1e9,
                         [g.cpu() for g in grads])
        finally:
            loops.checkpoint = inner
    diff = max(float((a - b).abs().max()) for a, b in zip(out["on"][2],
                                                          out["off"][2]))
    log(f"  {DIFF_OFF_SIZE[0]}x{DIFF_OFF_SIZE[1]} step, checkpoints on: "
        f"{out['on'][0]:.1f} ms, peak {out['on'][1]:.3f} GB above the "
        f"state; off: {out['off'][0]:.1f} ms, peak {out['off'][1]:.3f} GB; "
        f"gradients differ by at most {diff:.3e}")
    return {k: v[:2] for k, v in out.items()}


def phase_diff(dev, gen):
    """Phase 8, the differentiable slice (cornell_restir_fwdbwd_720p): card
    vs CPU, the launch check of one 720p step (whose K8-backward calls are
    captured), K8's backward against its plain version, the timed 720p
    step (bench.py:128-190's loop: 3 warm-up and DIFF_TIMED timed steps,
    synced),
    and the step with the checkpoints off. Returns (K8 backward's row,
    launches of the launch-check step)."""
    from sunray_tpu_torch.ops import cuda_build, cuda_trace
    from sunray_tpu_torch.render.pipeline import RenderState

    diff_card_vs_cpu(dev)
    w, h = DIFF_SIZE
    log(f"phase 8: {w}x{h} differentiable ReSTIR step (default config, "
        f"gradients w.r.t. base_color and positions)")
    cfg, scene, leaves, mats = diff_setup(dev, w, h)
    state = RenderState.create(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    (state, loss, grads, aux), calls = capture_bwd_calls(
        lambda: diff_step(cfg, scene, leaves, mats, state))
    torch.cuda.synchronize()
    launches = dict(cuda_build.launches)
    log(f"  launches in one step: {launches}")
    for name in DIFF_KERNELS:
        check(launches.get(name, 0) > 0, f"differentiable step: {name} "
              "never launched")
    for name in DIFF_ABSENT:
        check(launches.get(name, 0) == 0, f"differentiable step: {name} "
              "launched")
    row = k8_bwd_row(calls, gen, dev)
    del calls
    for _ in range(2):
        state, loss, grads, aux = diff_step(cfg, scene, leaves, mats, state)
    torch.cuda.synchronize()
    cuda_trace.rays.clear()
    n_timed = DIFF_TIMED
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, loss, grads, aux = diff_step(cfg, scene, leaves, mats, state)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # bench.py:179-183: the rays of one forward frame.
    rays = w * h * (aux["ris_rounds"] + 3 + max(aux["final_rounds"] - 1, 0)
                    + 2 + cfg.gi_spatial_samples)
    traced = sum(cuda_trace.rays.values()) / n_timed
    g_norms = [float(g.norm()) for g in grads]
    log(f"  step {step_s * 1e3:.3f} ms (mean of {n_timed} after 3 warm-up); "
        f"rays a step {rays} (bench.py's count; traced with the backward's "
        f"recompute: {traced:.0f}), {rays / step_s / 1e6:.2f} Mray/s "
        f"(fwd+bwd); walk rounds ris {aux['ris_rounds']} final "
        f"{aux['final_rounds']}; loss {float(loss):.6f}; |grad base_color| "
        f"{g_norms[0]:.6f}, |grad positions| {g_norms[1]:.6f}; peak memory "
        f"{peak_gb:.3f} GB")
    check(math.isfinite(float(loss)) and all(map(math.isfinite, g_norms)),
          "non-finite loss or gradient")
    check(g_norms[1] > 0.0, "zero positions gradient at 720p")
    stages = diff_stage_breakdown(cfg, scene, leaves, mats, state)
    off = diff_checkpoints_off(dev)
    row.update(step_ms=step_s * 1e3, step_peak_gb=peak_gb,
               step_mrays=rays / step_s / 1e6, step_stages_ms=stages,
               checkpoints_off_480x270=off)
    return row, launches


# -- phase 9: the visibility gradients ------------------------------------------

def capture_b1_calls(fn):
    """fn() with cuda_boundary.boundary_candidates recording its arguments:
    returns (fn's result, [(xs, nee_mask, edges, lights, k), ...])."""
    from sunray_tpu_torch.ops import cuda_boundary

    calls, inner = [], cuda_boundary.boundary_candidates

    def recording(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return inner(*args)

    cuda_boundary.boundary_candidates = recording
    try:
        return fn(), calls
    finally:
        cuda_boundary.boundary_candidates = inner


def b1_lanes_differing(got, want):
    """(light, pixel) lanes where B1's outputs differ from the plain
    version's in any rank of any array."""
    lanes = (got[1] != want[1])
    for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
        lanes = lanes | (a != b).any(dim=1)
    return int(lanes.sum())


def b1_needed_ops(xs, mask, edges, lights, step=1 << 16):
    """B1's fp32 operations on these inputs as its code decides them, each
    piece counted once for all lights where it does not depend on the
    light: both face-side tests of every (pixel, edge), as the reference
    computes its silhouette before its light loop
    (sunray_tpu/render/boundary.py:164-174, the loop :207); cnum of every
    (pixel, light); for a silhouette edge of a pixel in the mask, each
    light's projection tests in order (endpoint a, b, midpoint) up to the
    first that passes, each up to where it fails, with the point's
    difference pt - x once for the lights that test it; the score once a
    (pixel, edge) that passes for any light."""
    from sunray_tpu_torch.ops import cuda_boundary as cb
    from sunray_tpu_torch.ops import fp

    p, e_n, l_n = xs.shape[0], edges.shape[0], lights.shape[0]
    total = p * e_n * B1_SIDE_OPS + l_n * p * B1_CNUM_OPS
    for s in range(0, p, step):
        x = xs[s:s + step]
        sil, _ = cb.silhouette(x, edges)
        todo = [sil & mask[s:s + step, None] for _ in range(l_n)]
        cnum = [fp.dot(light[0:3] - x, light[3:6])[:, None]
                for light in lights]
        passed = torch.zeros_like(sil)
        for pt in (edges[:, 0:3], edges[:, 3:6], edges[:, 6:9]):
            d = pt - x[:, None, :]
            tested = torch.zeros_like(sil)
            for li, light in enumerate(lights):
                nl, lo, hi = light[3:6], light[6:9], light[9:12]
                denom = fp.dot(d, nl)
                heading = denom * cnum[li] > 0.0
                t_hit = cnum[li] / torch.where(denom.abs() > cb.DENOM_EPS,
                                               denom, cb.DENOM_EPS)
                beyond = heading & (t_hit > cb.BEYOND)
                y = fp.fma(t_hit[..., None], d, x[:, None, :])
                ok = beyond & ((y > lo) & (y < hi)).all(dim=-1)
                ops = torch.where(beyond, B1_PROJECT_OPS,
                                  torch.where(heading, B1_BEYOND_OPS,
                                              B1_HEAD_OPS))
                total += int((ops * todo[li]).sum())
                tested |= todo[li]
                passed |= ok & todo[li]
                todo[li] = todo[li] & ~ok
            total += int(tested.sum()) * B1_DIFF_OPS
        total += int(passed.sum()) * B1_SCORE_OPS
    return total


def random_edge_table(gen, dev, e_n):
    """An (e_n, EDGE_WORDS) edge table of random geometry in and around
    the Cornell box: endpoints, unit face normals and points, one face in
    four edges open."""
    from sunray_tpu_torch.ops import cuda_boundary

    def pts():
        return torch.rand((e_n, 3), generator=gen, device=dev) * 2.4 - 0.2

    def unit():
        v = torch.randn((e_n, 3), generator=gen, device=dev)
        return v / v.norm(dim=1, keepdim=True)

    has2 = torch.rand((e_n,), generator=gen, device=dev) > 0.25
    return cuda_boundary.edge_table(pts(), pts(), unit(), pts(), unit(),
                                    pts(), has2)


def b1_row(calls, gen, dev):
    """B1 against its plain version on the 720p step's own calls and on
    921,600 random points, on 65,536 of them for every K it is built for
    (with the step's table and a random one of more edges than a tile), 0
    lanes differing; timed on the step's first call beside its
    plain version and its bound."""
    from sunray_tpu_torch.ops import cuda_boundary

    xs0, mask0, edges, lights, k = calls[0]
    n = xs0.shape[0]
    rand = (torch.rand((n, 3), generator=gen, device=dev) * 2.2 - 0.1,
            torch.rand((n,), generator=gen, device=dev) > 0.1,
            edges, lights, k)
    worst = 0
    for label, args in ([(f"step call {i}", c) for i, c in enumerate(calls)]
                        + [("random", rand)]):
        got = cuda_boundary.boundary_candidates(*args)
        want = cuda_boundary.boundary_candidates_plain(*args)
        torch.cuda.synchronize()
        bad = b1_lanes_differing(got, want)
        worst = max(worst, bad)
        log(f"  B1, {label}: {args[0].shape[0]} pixels x {args[3].shape[0]} "
            f"lights x {args[2].shape[0]} edges, K={args[4]}, "
            f"{int(args[1].sum())} pixels in the mask, live candidates a "
            f"pixel max {int(got[1].max())}, mean "
            f"{float(got[1].float().mean()):.3f}; (light, pixel) lanes "
            f"differing from plain {bad}")
    # Every K, on the first 65,536 random points, with the step's table
    # and with a random one of more edges than a shared-memory tile.
    few = tuple(a[:65536] for a in rand[:2])
    wide = random_edge_table(gen, dev, 2 * cuda_boundary.EDGE_TILE + 88)
    sweep = {}
    for table in (edges, wide):
        for kk in range(1, cuda_boundary.MAX_K + 1):
            got = cuda_boundary.boundary_candidates(*few, table, lights, kk)
            want = cuda_boundary.boundary_candidates_plain(*few, table,
                                                           lights, kk)
            torch.cuda.synchronize()
            key = f"{table.shape[0]} edges"
            sweep[key] = max(sweep.get(key, 0), b1_lanes_differing(got, want))
    log(f"  B1 at K = 1..{cuda_boundary.MAX_K} on 65,536 random points, "
        f"(light, pixel) lanes differing at worst: {sweep}")
    worst = max(worst, *sweep.values())
    check(worst == 0, f"B1: {worst} lanes differ from the plain version")
    args = calls[0]
    l_n = lights.shape[0]
    out_bytes = l_n * n * (4 + k * (4 + 1 + 1))
    ops = b1_needed_ops(*args[:4])
    row = dict(
        max_abs_err=0.0, lanes_differing=worst, k_sweep=sweep,
        ms=device_ms(lambda: cuda_boundary.boundary_candidates(*args)),
        plain_ms=time_ms(lambda: cuda_boundary.boundary_candidates_plain(
            *args), reps=3),
        library_ms=None,
        bound=bound(nbytes(*args[:4]) + out_bytes, ops),
        needed_ops=ops, shape=[n, l_n, edges.shape[0], k],
        random_ms=device_ms(lambda: cuda_boundary.boundary_candidates(
            *rand)))
    log(f"  B1 at {n} pixels x {l_n} lights x {edges.shape[0]} edges, "
        f"K={k}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
        f"({row['bound'][1]}; {ops} operations); random set "
        f"{row['random_ms']:.4f} ms")
    return row


def vis_zero_forward(dev):
    """The 720p step with edge antialiasing, the shadow-boundary term on
    and off from a fresh state: the loss bit-equal (the term is zero in the
    forward pass), the positions gradient apart."""
    from sunray_tpu_torch.render.pipeline import RenderState

    out = {}
    for on in (False, True):
        kw = dict(VIS_KW, shadow_boundary_grads=on)
        cfg, scene, leaves, mats = diff_setup(dev, *DIFF_SIZE, **kw)
        _, loss, grads, _ = diff_step(cfg, scene, leaves, mats,
                                      RenderState.create(cfg, dev))
        out[on] = (loss.cpu(), grads[1].cpu())
    moved = float((out[True][1] - out[False][1]).abs().max())
    log(f"  zero forward at {DIFF_SIZE[0]}x{DIFF_SIZE[1]}: loss with the "
        f"term {float(out[True][0]):.9f}, without {float(out[False][0]):.9f}"
        f" (bit-equal {bool(torch.equal(out[True][0], out[False][0]))}); "
        f"the term moves the positions gradient by {moved:.6f} (largest "
        f"|g| without {float(out[False][1].abs().max()):.6f})")
    check(torch.equal(out[True][0], out[False][0]),
          "the shadow-boundary term changed the 720p loss")
    check(moved > 0.0, "the shadow-boundary term left the positions "
          "gradient unchanged")


def floating_box_scene(dev):
    """The floating-box scene of tests/test_grads.py:238-255, with its
    edge topology, and the ids of the box's 24 vertices."""
    from sunray_tpu_torch.render import boundary
    from sunray_tpu_torch.scene.procedural import _MeshBuilder

    b = _MeshBuilder()
    white = b.add_material(base_color=(0.73, 0.73, 0.73, 1.0), roughness=1.0)
    light = b.add_material(base_color=(1.0, 1.0, 1.0, 1.0),
                           emissive_factor=(1.0, 1.0, 1.0, 15.0),
                           roughness=1.0)
    s = 2.0
    b.add_quad((0, 0, 0), (0, 0, s), (s, 0, s), (s, 0, 0), white)
    b.add_quad((0, 0, 0), (s, 0, 0), (s, s, 0), (0, s, 0), white)
    b.add_quad((0, s, 0), (s, s, 0), (s, s, s), (0, s, s), white)
    ly = s - 0.01
    b.add_quad((0.95, ly, 0.65), (1.55, ly, 0.65), (1.55, ly, 1.35),
               (0.95, ly, 1.35), light)
    b.add_box((0.9, 1.2, 1.0), (0.5, 0.25, 0.5), white)
    scene = boundary.with_edge_topology(b.build(device=dev))
    pos = scene.positions
    return scene, (pos[:, 1] > 1.0) & (pos[:, 1] < 1.4)


def vis_ad_vs_fd(dev):
    """tests/test_grads.py's two occluder-translation cases on the card:
    AD of the frame-averaged raw radiance over the floor pixels eroded by
    3, against central differences, under an x shift of the box."""
    import dataclasses

    from scipy import ndimage

    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame

    w, h = FD_SIZE
    scene, box = floating_box_scene(dev)
    check(int(box.sum()) == 24, "floating box: 24 box vertices expected")
    shift = torch.zeros_like(scene.positions)
    shift[box, 0] = 1.0
    mats = camera_matrices(Camera(**FD_CAMERA), w, h, device=dev)
    out = {}
    for name, (kw, frames, eps, rtol) in FD_CASES.items():
        cfg = RenderConfig(width=w, height=h, bounces=2, virtual_bounces=2,
                           denoise_passes=0, enable_taa=False,
                           differentiable=True, tonemap="none",
                           shadow_boundary_grads=True, **kw)

        def render_k(dx):
            sc = dataclasses.replace(scene,
                                     positions=scene.positions + dx * shift)
            state, acc, aux = RenderState.create(cfg, dev), 0.0, None
            for _ in range(frames):
                state, _, aux = render_frame(sc, cfg, state, mats)
                acc = acc + aux["raw"]
            return acc / frames, aux

        with torch.no_grad():
            _, aux0 = render_k(torch.zeros((), device=dev))
        floor = (aux0["normal"][..., 1] > 0.9).cpu().numpy()
        eroded = ndimage.binary_erosion(floor, iterations=3)
        mask = torch.from_numpy(eroded[..., None].astype(np.float32)).to(dev)

        def loss(dx):
            img, _ = render_k(dx)
            return (img * mask).sum() / mask.sum()

        dx = torch.zeros((), device=dev, requires_grad=True)
        g_ad = float(torch.autograd.grad(loss(dx), dx)[0])
        with torch.no_grad():
            fd = (float(loss(torch.tensor(eps, device=dev)))
                  - float(loss(torch.tensor(-eps, device=dev)))) / (2 * eps)
        ratio = g_ad / fd
        log(f"  AD vs FD, {name} ({frames} frames, {w}x{h}, eps {eps}, "
            f"{int(eroded.sum())} floor pixels): AD {g_ad:.6f}, FD {fd:.6f}, "
            f"ratio {ratio:.4f} (rtol {rtol})")
        check(abs(fd) > 0.3, f"{name}: shadow FD signal too small: {fd}")
        check(abs(g_ad - fd) <= rtol * abs(fd),
              f"{name}: AD {g_ad} vs FD {fd} outside rtol {rtol}")
        out[name] = dict(ad=g_ad, fd=fd)
    return out


def phase_visibility(dev, gen):
    """Phase 9, the visibility gradients: card vs CPU with both terms, the
    zero forward at 720p, the launch check of one 720p step with both terms
    (B1's calls captured), B1 against its plain version, the timed 720p
    step (bench.py:128-190's loop: 3 warm-up and DIFF_TIMED timed steps,
    synced)
    with its peak memory, and AD against FD; K8's backward on the
    launch-check step's calls. Returns (B1's row with the step's numbers,
    launches of the launch-check step, the K8-backward visibility calls'
    times)."""
    from sunray_tpu_torch.ops import cuda_build, cuda_trace
    from sunray_tpu_torch.render.pipeline import RenderState

    diff_card_vs_cpu(dev, phase=9, **VIS_KW)
    diff_card_vs_cpu(dev, phase=9, lighting="nee", shadow_boundary_grads=True,
                     edge_antialias=True)
    w, h = DIFF_SIZE
    log(f"phase 9: {w}x{h} differentiable ReSTIR step with both visibility "
        f"terms ({VIS_KW})")
    vis_zero_forward(dev)
    cfg, scene, leaves, mats = diff_setup(dev, w, h, **VIS_KW)
    state = RenderState.create(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    ((state, loss, grads, aux), calls), bwd_calls = capture_bwd_calls(
        lambda: capture_b1_calls(
            lambda: diff_step(cfg, scene, leaves, mats, state)))
    torch.cuda.synchronize()
    launches = dict(cuda_build.launches)
    log(f"  launches in one step: {launches}")
    for name in VIS_KERNELS:
        check(launches.get(name, 0) > 0, f"step with both terms: {name} "
              "never launched")
    for name in DIFF_ABSENT:
        check(launches.get(name, 0) == 0, f"step with both terms: {name} "
              "launched")
    check(launches["gather_rows_bwd"] == len(bwd_calls),
          f"step with both terms: K8's backward launched "
          f"{launches['gather_rows_bwd']} times, {len(bwd_calls)} calls")
    row = b1_row(calls, gen, dev)
    bwd_vis = k8_bwd_vis_calls(bwd_calls)
    del calls, bwd_calls
    for _ in range(2):
        state, loss, grads, aux = diff_step(cfg, scene, leaves, mats, state)
    torch.cuda.synchronize()
    cuda_trace.rays.clear()
    n_timed = DIFF_TIMED
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, loss, grads, aux = diff_step(cfg, scene, leaves, mats, state)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rays = w * h * (aux["ris_rounds"] + 3 + max(aux["final_rounds"] - 1, 0)
                    + 2 + cfg.gi_spatial_samples)
    traced = sum(cuda_trace.rays.values()) / n_timed
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    g_norms = [float(g.norm()) for g in grads]
    log(f"  step with both terms {step_s * 1e3:.3f} ms (mean of {n_timed} "
        f"after 3 warm-up); rays a step {rays} (bench.py's count; traced "
        f"with the backward's recompute: {traced:.0f}), "
        f"{rays / step_s / 1e6:.2f} Mray/s (fwd+bwd); loss "
        f"{float(loss):.6f}; |grad base_color| {g_norms[0]:.6f}, |grad "
        f"positions| {g_norms[1]:.6f}; every gradient entry finite {finite}; "
        f"peak memory {peak_gb:.3f} GB (limit {VIS_PEAK_GB})")
    check(finite and math.isfinite(float(loss)), "non-finite loss or "
          "gradient entry with both terms")
    check(peak_gb <= VIS_PEAK_GB, f"peak memory {peak_gb} GB > {VIS_PEAK_GB}")
    stages = diff_stage_breakdown(cfg, scene, leaves, mats, state)
    fd = vis_ad_vs_fd(dev)
    row.update(step_ms=step_s * 1e3, step_peak_gb=peak_gb,
               step_mrays=rays / step_s / 1e6, step_stages_ms=stages,
               step_launches=launches, ad_vs_fd=fd)
    return row, launches, bwd_vis


def ptxas_registers(report):
    """{kernel: registers} from nvcc's -Xptxas=-v report, each kernel named
    as in its mangled name without its source's anonymous namespace
    (_GLOBAL__N__<hash>_<n>_<file>_cu_<hash>), template arguments kept
    (e.g. ...14closest_kernelILi4EEEvPKf...: closest_kernelILi4EE)."""
    import re

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '_ZN\d+_GLOBAL__N__\w+?_cu_"
                      r"[0-9a-f]{8}(\d+)(\w+)'", line)
        if m:
            size, rest = int(m.group(1)), m.group(2)
            name, tail = rest[:size], rest[size:]
            if tail.startswith("I") and "EE" in tail:
                name += tail[:tail.index("EE") + 2]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = int(m.group(1))
            name = None
    return out


def resident_warps(registers, threads):
    """Warps an H100 SM holds of a kernel using `registers` registers a
    thread in blocks of `threads`: 64K registers an SM, allocated 256 a
    warp at a time; at most 64 warps and 32 blocks an SM."""
    per_warp = -(-registers * 32 // 256) * 256
    warps = threads // 32
    blocks = min(65536 // (per_warp * warps), 32, 64 // warps)
    return blocks * warps


def kernel_registers(regs, kernel, threads):
    """{instantiation: (registers, resident warps an SM)} of `kernel`."""
    return {name: (n, resident_warps(n, threads)) for name, n in regs.items()
            if name.startswith(kernel)}


# -- phase 10: a real scene through the Renderer (B2, B3) ---------------------

# The synthetic glTF scene (tools/synth_gltf.py): eight 1024x1024 RGBA
# textures, the reflection room, a 16-quad MASK panel grid, a 5,120-
# triangle icosphere instanced 50 times (256,068 triangles, padded to
# 262,144). With 48 instances (245,828) the padding's 16,316 degenerate
# triangles belong to instance 0, and the largest instance that
# _auto_big_mode counts (renderer.py:160-168, in both packages) exceeds
# bvh2_blas_max_tris: "auto" would take the binned tracer.
REAL_GLB = dict(seed=10, tex=1024, subdiv=4, spheres=50)
REAL_WARM, REAL_TIMED = 2, 4    # 5, 10 before phase 12 joined the
                                # script, 3, 6 before phase 15 did
REAL_ANIMATE = 3            # set_instances frames (AsState UPDATE refits;
                            # 8 before phase 12 joined the script)
WALK_LANES = 65536          # lanes of each query held to the plain twin
REAL_SMALL = dict(width=96, height=54)
REAL_SMALL_FRAMES = 2       # 3 before phase 12 joined the script


def real_scene_path():
    """Write the phase's GLB under build/ (ignored by git) and return it."""
    from tools.synth_gltf import write_scene

    path = os.path.join(REPO, "build", "phase10", "scene.glb")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return write_scene(path, **REAL_GLB)


def capture_traces(render):
    """The tracer queries of one call of render(): [(kind, label, tracer
    context, (o, d, tmin, tmax), exclude)] in order, kind "closest" or
    "occluded",
    from the trace_closest / trace_occluded calls of the G-buffer and final
    passes (render/gbuffer.py, render/pathtrace.py), with the rays, bounds
    and exclude ids a walk gets (an occlusion query's tmax less 1e-3)."""
    import inspect

    from sunray_tpu_torch.ops import bvh
    from sunray_tpu_torch.render import gbuffer, pathtrace, trace

    calls = []
    sig = {name: inspect.signature(getattr(trace, name))
           for name in ("trace_closest", "trace_occluded")}
    saved = [(m, name, getattr(m, name)) for m in (gbuffer, pathtrace)
             for name in sig]

    def wrap(mod, name, fn):
        def call(*args, **kwargs):
            a = sig[name].bind(*args, **kwargs)
            a.apply_defaults()
            calls.append((mod.__name__.rsplit(".", 1)[1], name, a.arguments))
            return fn(*args, **kwargs)
        return call

    try:
        for m, name, fn in saved:
            setattr(m, name, wrap(m, name, fn))
        render()
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    out = []
    for mod, name, a in calls:
        ctx = a["ctx"]
        if name == "trace_closest":
            rays = bvh._rays(a["orig"], a["d"], a["tmin"], a["tmax"])
            label = ("camera" if mod == "gbuffer" and not out
                     else "GI bounce" if mod == "gbuffer" and not a["coherent"]
                     else f"{mod} closest")
            out.append(("closest", label, ctx, rays, None))
        else:
            tmax = torch.as_tensor(a["tmax"], dtype=torch.float32,
                                   device=a["orig"].device)
            rays = bvh._rays(a["orig"], a["d"], a["tmin"], tmax - 1e-3)
            ex = a["exclude"]
            ex = None if ex is None else ex.reshape(-1).to(torch.int32).contiguous()
            out.append(("occluded", f"{mod} shadow", ctx, rays, ex))
    torch.cuda.synchronize()
    return out


def walk_bound(rays, tests, closest, exclude):
    """(ms, by) of a walk: each ray's inputs read once (o, d, tmin, tmax,
    exclude) and outputs written once, against the slab and triangle tests
    the reference's traversal order runs for these rays (the plain twin's
    counts, which the kernel's counters equal)."""
    n = rays[0].shape[0]
    n_bytes = n * (32 + (4 if exclude is not None else 0)
                   + (17 if closest else 1))
    box, tri = tests.sum(0).tolist()
    return bound(n_bytes, box * SLAB_OPS + tri * TEST_OPS)


def walk_key(tables, closest, alpha=False):
    """WALK_SASS's key of the walk instantiation a query launches."""
    return ("b3" if tables.two_level else "b2") + ("_alpha" if alpha else "") \
        + ("" if closest else "_any")


def spread(n, device, full=False):
    """WALK_LANES lanes spread over n (all of them with full)."""
    return (torch.arange(n, device=device) if full or n <= WALK_LANES
            else torch.linspace(0, n - 1, WALK_LANES, device=device).long())


def walk_check(kind, label, ctx, rays, exclude, counts, full_plain=False):
    """B2 or B3 on one captured query, walked without alpha cutout: the
    kernel's time on all its rays, its bound and its issue floor from its
    own test counters; the kernel against the plain twin
    (ops/bvh.walk_plain) on WALK_LANES lanes spread over the query (all of
    them with full_plain): tri and hit bit-equal, t, u, v lanes differing
    counted with the largest difference, the test counts equal."""
    from sunray_tpu_torch.ops import bvh, cuda_bvh

    tables = ctx.walk
    o, d, tn, tx = rays
    n = o.shape[0]
    closest = kind == "closest"
    ex = None if closest else exclude
    tests = torch.empty((n, 2), dtype=torch.int32, device=o.device)
    full = cuda_bvh._launch(tables, o, d, tn, tx, ex, not closest, tests=tests)
    ms = device_ms(lambda: cuda_bvh._launch(tables, o, d, tn, tx, ex,
                                             not closest))
    b_ms, b_by = walk_bound(rays, tests.long(), closest, ex)
    floor = walk_floor(counts, walk_key(tables, closest), tests)
    sel = spread(n, o.device, full_plain)
    sub = tuple(x[sel].contiguous() for x in rays)
    sub_ex = None if ex is None else ex[sel].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = bvh.walk_plain(tables, *sub, any_hit=not closest, exclude=sub_ex)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kt, ktri, ku, kv, khit = (None if x is None else x[sel] for x in full)
    check(bool((khit == plain.found).all()),
          f"{label}: hit differs on {int((khit != plain.found).sum())} lanes")
    check(bool((tests[sel] == torch.stack([plain.box_tests, plain.tri_tests],
                                          1).to(torch.int32)).all()),
          f"{label}: the kernel's test counts differ from the plain twin's")
    row = dict(label=label, rays=n, lanes=int(sel.numel()), ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, floor_ms=floor,
               box_tests_a_ray=float(tests[:, 0].float().mean()),
               tri_tests_a_ray=float(tests[:, 1].float().mean()),
               exclude=ex is not None, max_abs_err=0.0)
    if closest:
        check(bool((ktri == plain.tri).all()),
              f"{label}: tri differs on {int((ktri != plain.tri).sum())} lanes")
        pt = torch.where(plain.found, plain.t, torch.inf)
        diff = {}
        for name, k, p in (("t", kt, pt), ("u", ku, plain.u), ("v", kv, plain.v)):
            m = khit & (k.view(torch.int32) != p.view(torch.int32))
            diff[name] = (int(m.sum()),
                          float((k[m] - p[m]).abs().max()) if m.any() else 0.0)
        row["tuv_lanes_differing"] = {k: v[0] for k, v in diff.items()}
        row["max_abs_err"] = max(v[1] for v in diff.values())
    log(f"  {label}: {n} rays, {row['box_tests_a_ray']:.1f} box + "
        f"{row['tri_tests_a_ray']:.1f} triangle tests a ray; kernel "
        f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / ms:.1%}), issue floor "
        + ("not measured" if floor is None else f"{floor:.4f} ms")
        + f"; plain twin {plain_ms:.1f} ms on {row['lanes']} "
        f"lanes; tri/hit bit-equal on {row['lanes']} lanes"
        + (f", t/u/v lanes differing {row['tuv_lanes_differing']} (max "
           f"{row['max_abs_err']:.3g})" if closest else ""))
    return row


def hits_differing(a, b):
    """Lanes where two Hits differ in any bit of t, tri, u, v or hit."""
    differ = (a.hit != b.hit) | (a.tri != b.tri)
    for x, y in ((a.t, b.t), (a.u, b.u), (a.v, b.v)):
        differ |= x.view(torch.int32) != y.view(torch.int32)
    return int(differ.sum())


def alpha_check(kind, label, ctx, rays, exclude, counts):
    """One query of the frame as the frame runs it: B2 or B3 with alpha
    cutout inside the walk (one launch) on every ray, against the route
    it replaced, the batch rounds over the walk kernel
    (render/trace.closest_alpha_rounds / occluded_alpha_rounds), on every
    lane (t, tri, u, v and hit, or occlusion, bit-equal), and against the
    plain twin (ops/bvh.walk_alpha_plain) on WALK_LANES lanes with the
    test counts equal; both routes timed, the fused walk beside its bound
    and issue floor from its own counters (the walks a ray makes)."""
    from sunray_tpu_torch.ops import bvh, cuda_bvh
    from sunray_tpu_torch.ops.intersect import Hit
    from sunray_tpu_torch.render import trace

    o, d, tn, tx = rays
    n = o.shape[0]
    closest = kind == "closest"
    rounds = ctx.alpha_rounds

    def fused(tests=None):
        return cuda_bvh._launch(ctx.walk, o, d, tn, tx, exclude, not closest,
                                tests=tests, alpha=ctx.alpha, rounds=rounds)

    def batch():
        if closest:
            return trace.closest_alpha_rounds(ctx, o, d, tn, tx)
        return trace.occluded_alpha_rounds(ctx, o, d, tx, tn, exclude)

    tests = torch.empty((n, 2), dtype=torch.int32, device=o.device)
    full = fused(tests)
    old = batch()
    if closest:
        every = hits_differing(Hit(*full), old)
    else:
        every = int((full[4] != old).sum())
    check(every == 0, f"{label}: the fused alpha walk differs from the batch "
          f"rounds on {every} lanes")
    ms = device_ms(fused)
    rounds_ms = time_ms(batch)
    b_ms, b_by = walk_bound(rays, tests.long(), closest, exclude)
    floor = walk_floor(counts, walk_key(ctx.walk, closest, alpha=True), tests)
    sel = spread(n, o.device)
    sub = tuple(x[sel].contiguous() for x in rays)
    sub_ex = None if exclude is None else exclude[sel].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = bvh.walk_alpha_plain(ctx.walk, ctx.alpha, *sub, rounds,
                                 any_hit=not closest, exclude=sub_ex)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if closest:
        lanes = hits_differing(Hit(*(x[sel] for x in full)), Hit(*plain[:5]))
    else:
        lanes = int((full[4][sel] != plain.found).sum())
    check(lanes == 0, f"{label}: the fused alpha walk differs from its plain "
          f"twin on {lanes} lanes")
    check(bool((tests[sel] == torch.stack([plain.box_tests, plain.tri_tests],
                                          1).to(torch.int32)).all()),
          f"{label}: the fused walk's test counts differ from the twin's")
    row = dict(label=label, kind=kind, rays=n, lanes=int(sel.numel()), ms=ms,
               rounds_ms=rounds_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, floor_ms=floor, exclude=exclude is not None,
               box_tests_a_ray=float(tests[:, 0].float().mean()),
               tri_tests_a_ray=float(tests[:, 1].float().mean()))
    log(f"  {label} (alpha, {kind}): {n} rays, fused {ms:.4f} ms, batch "
        f"rounds {rounds_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), floor "
        + ("not measured" if floor is None else f"{floor:.4f} ms")
        + f", {row['box_tests_a_ray']:.1f} box + {row['tri_tests_a_ray']:.1f} "
        f"triangle tests a ray; bit-equal to the rounds on every lane and to "
        f"the plain twin on {row['lanes']} lanes")
    return row


def real_run(dev, path, tracer, walk_name, counts, animate=False,
             profile=False):
    """One 1080p default ReSTIR run through Renderer.load_gltf / render:
    frame ms (REAL_WARM warm-up frames, REAL_TIMED timed, synced), Mray/s
    by bench.py's count, ldr_mean, the accel op of every frame, the walk
    kernel's launches a frame, the synced stage times (and with profile
    one profiled frame's device time by kernel), and the walk's times on
    the frame's own queries."""
    from sunray_tpu_torch.camera import Camera
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build, cuda_trace
    from sunray_tpu_torch.render.renderer import Renderer
    from tools.synth_gltf import CAMERA as REAL_CAMERA

    cfg = RenderConfig(width=1920, height=1080, tracer=tracer)
    r = Renderer(cfg, device=dev)
    t0 = time.perf_counter()
    instances = r.load_gltf(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cam = Camera(**REAL_CAMERA)
    log(f"phase 10 ({tracer}): {r.scene.num_tris} triangles (padded), "
        f"{len(instances)} instances, atlas {tuple(r.scene.textures.data.shape)}"
        f", alpha cutout {r.config.alpha_mask_tracing}; load_gltf {load_s:.2f} s")
    ops = []
    cuda_build.launches.clear()
    cuda_trace.rays.clear()
    cuda_trace.queries.clear()
    t0 = time.perf_counter()
    for _ in range(REAL_WARM):
        r.render(cam)
        ops.append(r.last_accel_op)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rays0 = sum(cuda_trace.rays.values())
    expected = 0
    t0 = time.perf_counter()
    for _ in range(REAL_TIMED):
        ldr = r.render(cam)
        ops.append(r.last_accel_op)
        expected += rays_expected(r.config, r.last_aux)
    torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / REAL_TIMED
    frames = REAL_WARM + REAL_TIMED
    launches = dict(cuda_build.launches)
    traced = sum(cuda_trace.queries.values())
    rays = (sum(cuda_trace.rays.values()) - rays0) / REAL_TIMED
    ldr_np = ldr.cpu().numpy()
    mean = float(ldr_np.mean())
    log(f"  warm-up {REAL_WARM} frames {warm_s:.2f} s; frame "
        f"{frame_s * 1e3:.2f} ms (mean of {REAL_TIMED}, synced); "
        f"rays/frame {rays:.0f} ({rays / frame_s / 1e6:.2f} Mray/s); "
        f"ldr_mean {mean:.5f}; accel {type(r._accel).__name__}, ops {ops}")
    log(f"  launches over {frames} frames: {launches}; {walk_name} "
        f"{launches.get(walk_name, 0) / frames:.1f} a frame")
    check(rays * REAL_TIMED == expected,
          f"rays/frame {rays} != bench.py's count {expected / REAL_TIMED}")
    check(bool(np.isfinite(ldr_np).all()), "non-finite ldr")
    check(0.02 < mean < 0.95, f"ldr_mean {mean}")
    check(launches.get(walk_name, 0) > 0, f"{walk_name} never launched")
    for other in REAL_ONLY + ("trace_closest", "trace_occluded"):
        if other != walk_name:
            check(launches.get(other, 0) == 0, f"{other} launched")
    from sunray_tpu_torch.camera import camera_matrices

    mats = camera_matrices(cam, cfg.width, cfg.height, device=dev)
    stage_breakdown(r.scene, r.config, r.state, mats, frame_s, r._accel)
    if profile:
        profile_frame(r.scene, r.config, r.state, mats, r._accel)
    check(launches[walk_name] <= traced,
          f"{walk_name}: {launches[walk_name]} launches in {frames} frames "
          f"of {traced} trace queries")
    log(f"  {traced / frames:.2f} trace queries a frame, {walk_name} "
        f"{launches[walk_name] / frames:.2f} launches a frame")
    queries = capture_traces(lambda: r.render(cam))
    pick = [q for q in queries if q[1] == "camera"][:1] + \
        [q for q in queries if q[1] == "GI bounce"][:1] + \
        [q for q in queries if q[0] == "occluded" and q[4] is not None][:1]
    check(len(pick) == 3, f"queries captured: {[q[1] for q in queries]}")
    rows = [walk_check(*q, counts, full_plain=(q[1] == "camera"))
            for q in pick]
    alpha_rows = [alpha_check(*q, counts) for q in queries
                  if q[3][0].shape[0] > 0]
    result = dict(frame_ms=frame_s * 1e3, mrays=rays / frame_s / 1e6,
                  ldr_mean=mean, ops=ops, launches_a_frame=launches[walk_name]
                  / frames, launches=launches[walk_name], queries=rows,
                  alpha_queries=alpha_rows, queries_a_frame=traced / frames)
    if animate:
        result["animation_ops"] = real_animate(r, cam, instances)
    return result


def real_animate(r, cam, instances):
    """REAL_ANIMATE frames of set_instances transform animation (the
    spheres rise; AsState UPDATE refits), then a spawn (one more sphere;
    a FAST_BUILD LBVH). Returns the op of each frame."""
    sphere_key = max((k for k, _ in instances), key=lambda k: sum(
        1 for kk, _ in instances if kk == k))
    ops = []
    for f in range(REAL_ANIMATE):
        moved = [(k, _lift(t, 0.03 * (f + 1)) if k == sphere_key
                  else np.asarray(t, np.float32)) for k, t in instances]
        r.render(cam, instances=moved)
        ops.append(r.last_accel_op)
    spawn = moved + [(sphere_key, _lift(moved[-1][1], 0.5))]
    ldr = r.render(cam, instances=spawn)
    ops.append(r.last_accel_op)
    torch.cuda.synchronize()
    check(ops == ["update"] * REAL_ANIMATE + ["fast_build"],
          f"accel ops of the animation and spawn: {ops}")
    check(bool(torch.isfinite(ldr).all()), "non-finite ldr after the spawn")
    log(f"  set_instances animation then a spawn: accel ops {ops}")
    return ops


def _lift(t, dy):
    t = np.array(t, np.float32)
    t[1, 3] += dy
    return t


def real_card_vs_cpu(dev, path):
    """The same scene at REAL_SMALL for REAL_SMALL_FRAMES frames through
    the Renderer (tracer "auto": the two-level walk) on the card and on
    the CPU port: PSNR above PSNR_MIN every frame."""
    from sunray_tpu_torch.camera import Camera
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.renderer import Renderer
    from tools.synth_gltf import CAMERA as REAL_CAMERA

    cam = Camera(**REAL_CAMERA)
    out = {}
    for device in (dev, torch.device("cpu")):
        r = Renderer(RenderConfig(**REAL_SMALL), device=device)
        r.load_gltf(path)
        out[device.type] = [r.render(cam).cpu().numpy()
                            for _ in range(REAL_SMALL_FRAMES)]
        out[device.type + "_accel"] = type(r._accel).__name__
    p = [psnr(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    log(f"phase 10: {REAL_SMALL['width']}x{REAL_SMALL['height']} card vs CPU, "
        f"{REAL_SMALL_FRAMES} frames ({out['cuda_accel']} / "
        f"{out['cpu_accel']}): PSNR {[round(x, 2) for x in p]} dB")
    check(out["cuda_accel"] == out["cpu_accel"] == "BlasSet",
          f"accels {out['cuda_accel']} / {out['cpu_accel']}")
    check(min(p) > PSNR_MIN, f"card vs CPU PSNR {min(p):.2f} dB")
    return p


def phase_real_scene(dev, counts):
    """Phase 10: the synthetic glTF scene through the Renderer: (a) tracer
    "auto" (B3), (b) tracer "bvh" (SAH, then UPDATE refits and a
    FAST_BUILD; B2), (c) each walk against its plain twin on the frames'
    own queries, (d) each fused alpha query against the batch rounds and
    its twin, (e) card against CPU. counts: sass_counts' (the walks' issue
    floors). Returns the kernel rows and launches of B2 and B3."""
    t_phase = time.perf_counter()
    path = real_scene_path()
    log(f"phase 10: wrote {os.path.relpath(path, REPO)} "
        f"({os.path.getsize(path) / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    runs = {"bvh2_walk": real_run(dev, path, "auto", "bvh2_walk", counts,
                                  profile=True),
            "bvh_walk": real_run(dev, path, "bvh", "bvh_walk", counts,
                                 animate=True)}
    card_cpu = real_card_vs_cpu(dev, path)
    rows, launches = {}, {}
    for name, run in runs.items():
        cam = run["queries"][0]
        rows[name] = dict(
            max_abs_err=max(q["max_abs_err"] for q in run["queries"]),
            ms=cam["ms"], plain_ms=cam["plain_ms"],
            bound=(cam["bound_ms"], cam["bound_by"]), floor_ms=cam["floor_ms"],
            alpha_queries=run["alpha_queries"],
            queries_a_frame=run["queries_a_frame"],
            shape=f"{cam['rays']} camera rays x {REAL_GLB['spheres']} x "
                  f"{20 * 4 ** REAL_GLB['subdiv']} + room triangles",
            queries=run["queries"], frame_ms=run["frame_ms"],
            frame_mrays=run["mrays"], ldr_mean=run["ldr_mean"],
            accel_ops=run["ops"] + run.get("animation_ops", []),
            launches_a_frame=run["launches_a_frame"],
            card_vs_cpu_psnr=card_cpu if name == "bvh2_walk" else None)
        launches[name] = run["launches"]
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return rows, launches


# -- phase 11: differentiable real scenes (K8's backward above 512 rows) -----

# The CPU tests' GLB (tests/torch_gltf_grad_cases.py): 178 vertex rows,
# 1,024 triangles, an 8 x 16 x 16 atlas, a glass box, alpha cutout.
REAL_DIFF_GLB = dict(seed=0, tex=16, subdiv=1, spheres=8)
# tests/test_grads.py's frame; "auto" takes the two-level tracer on both
# devices (the CPU's brute limit is 512 triangles, the card's 4,096).
REAL_DIFF_KW = dict(bounces=2, virtual_bounces=2, denoise_passes=0,
                    enable_taa=False, tonemap="none", brute_force_max_tris=512)
REAL_DIFF_CASES = (("nee", "bvh"), ("nee", "auto"), ("restir", "bvh"),
                   ("restir", "auto"))
REAL_DIFF_SMALL = (96, 64)
REAL_DIFF_FLOOR = 1e-5      # card vs CPU: of the largest finite |gradient|
REAL_DIFF_WARM, REAL_DIFF_TIMED = 1, 3   # 3, 10 before phase 12, 2, 4
                                         # before phase 15
REAL_DIFF_PARAMS = ("positions", "base_color", "inst_transform", "textures")
# A differentiable real-scene step ("auto": B3): the walk, K8 forward and
# backward, the runs path; the plain K3-K7, K9 and K13; no K1, K2.
REAL_DIFF_KERNELS = ("bvh2_walk", "gather_rows", "gather_rows_multi",
                     "gather_rows_bwd", "gather_rows_bwd_runs")
BIG_DIFF_KERNELS = BINNED_KERNELS + ("gather_rows", "gather_rows_multi",
                                     "gather_rows_bwd", "gather_rows_bwd_runs")


def real_diff_setup(dev, path, width, height, **kw):
    """The GLB at `path` through Renderer.load_gltf at width x height,
    differentiable: (config with the scene's alpha flag, scene with the
    REAL_DIFF_PARAMS as leaves that require grad, leaves, matrices,
    accel)."""
    import dataclasses

    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.renderer import Renderer
    from tools.synth_gltf import CAMERA as REAL_CAMERA

    r = Renderer(RenderConfig(width=width, height=height, differentiable=True,
                              **kw), device=dev)
    r.load_gltf(path)
    sc = r.scene
    leaves = tuple(x.detach().clone().requires_grad_() for x in
                   (sc.positions, sc.materials.base_color, sc.inst_transform,
                    sc.textures.data))
    scene = dataclasses.replace(
        sc, positions=leaves[0], inst_transform=leaves[2],
        materials=dataclasses.replace(sc.materials, base_color=leaves[1]),
        textures=dataclasses.replace(sc.textures, data=leaves[3]))
    mats = camera_matrices(Camera(**REAL_CAMERA), width, height, device=dev)
    return r.config, scene, leaves, mats, r._scene_accel()


def real_diff_step(cfg, scene, leaves, mats, state, accel):
    """One step: mean(ldr) and its gradients w.r.t. the leaves (None
    where a leaf is unused, as a textureless scene's atlas); the next
    state."""
    from sunray_tpu_torch.render.pipeline import render_frame

    state, ldr, aux = render_frame(scene, cfg, state, mats, accel)
    loss = ldr.mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return state, loss.detach(), grads, aux


def real_diff_small_path():
    from tools.synth_gltf import write_scene

    path = os.path.join(REPO, "build", "phase11", "small.glb")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return write_scene(path, **REAL_DIFF_GLB)


def real_diff_card_vs_cpu(dev):
    """The small GLB's differentiable frame at REAL_DIFF_SMALL, NEE and
    ReSTIR through "bvh" and "auto", on the card and on the CPU: losses
    within DIFF_LOSS_RTOL, each gradient's NaN mask equal and its finite
    entries within REAL_DIFF_FLOOR of its largest finite entry."""
    from sunray_tpu_torch.render.pipeline import RenderState

    path = real_diff_small_path()
    out = {}
    for lighting, tracer in REAL_DIFF_CASES:
        res = {}
        for device in (dev, torch.device("cpu")):
            cfg, scene, leaves, mats, accel = real_diff_setup(
                device, path, *REAL_DIFF_SMALL, lighting=lighting,
                tracer=tracer, **REAL_DIFF_KW)
            _, loss, grads, _ = real_diff_step(
                cfg, scene, leaves, mats, RenderState.create(cfg, device),
                accel)
            res[device.type] = (float(loss), [g.cpu() for g in grads],
                                type(accel).__name__)
        (lg, gg, ag), (lc, gc, ac) = res["cuda"], res["cpu"]
        rel = abs(lg - lc) / abs(lc)
        worst, nans, same = {}, {}, True
        for name, a, b in zip(REAL_DIFF_PARAMS, gg, gc):
            mask = torch.isnan(b)
            same &= bool(torch.equal(torch.isnan(a), mask))
            fin = torch.isfinite(b)
            top = float(b[fin].abs().max()) if bool(fin.any()) else 0.0
            diff = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) \
                else 0.0
            worst[name] = diff / top if top > 0 else diff
            nans[name] = int(mask.sum())
        log(f"phase 11: {REAL_DIFF_SMALL[0]}x{REAL_DIFF_SMALL[1]} {lighting} "
            f"{tracer} ({ag} / {ac}): loss card {lg:.8f} CPU {lc:.8f} (rel "
            f"{rel:.2e}); max diff / max finite |g|: "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + f"; NaN entries (CPU) {nans}; NaN masks equal {same}")
        check(ag == ac, f"{lighting} {tracer}: accels {ag} / {ac}")
        check(rel <= DIFF_LOSS_RTOL, f"{lighting} {tracer}: loss rel {rel}")
        check(same, f"{lighting} {tracer}: NaN masks differ card vs CPU")
        for name, v in worst.items():
            check(v <= REAL_DIFF_FLOOR, f"{lighting} {tracer}: {name} "
                  f"gradient card vs CPU {v:.2e} of its largest entry")
        out[f"{lighting}_{tracer}"] = dict(loss_rel=rel, grad_rel=worst,
                                           nan_entries=nans)
    return out


def runs_timing(label, call, dev):
    """One runs-path call timed beside its plain version, its bound (ct
    and idx read once, the table written once), index_add_ and
    index_put_(accumulate=True) on the (G*N, C) rows, its own hand sort
    alone (hand_sort_ms) and torch.sort(stable=True) of the same clamped
    ids (sort_ms: the library's sort, which the runs path called before
    its own)."""
    from sunray_tpu_torch.ops import cuda_gather

    ct, idx, k = call
    c = ct.shape[1]
    rows = ct.permute(0, 2, 1).reshape(-1, c).contiguous()
    cidx = idx.long().clamp(0, k - 1).reshape(-1)
    keys = cidx.to(torch.int32)
    dtab = torch.zeros((k, c), dtype=torch.float32, device=dev)
    out = dict(
        shape=[list(idx.shape), k, c],
        ms=device_ms(lambda: cuda_gather.gather_rows_bwd(ct, idx, k)),
        plain_ms=time_ms(lambda: cuda_gather.gather_rows_bwd_plain(ct, idx,
                                                                   k)),
        library_ms=device_ms(lambda: dtab.zero_().index_add_(0, cidx, rows)),
        index_put_ms=device_ms(lambda: dtab.zero_().index_put_(
            (cidx,), rows, accumulate=True)),
        hand_sort_ms=device_ms(lambda: cuda_gather.runs_sort(idx, k)),
        sort_ms=device_ms(lambda: torch.sort(keys, stable=True)),
        bound=bound(nbytes(ct, idx) + k * c * 4, 0))
    log(f"  runs path, {label} {tuple(idx.shape)} into {k} x {c}: "
        f"{out['ms']:.4f} ms (its hand sort alone {out['hand_sort_ms']:.4f}, "
        f"torch.sort {out['sort_ms']:.4f}), bound {out['bound'][0]:.4f} ms "
        f"({out['bound'][1]}), plain {out['plain_ms']:.4f} ms, index_add_ "
        f"{out['library_ms']:.4f} ms, index_put_(accumulate=True) "
        f"{out['index_put_ms']:.4f} ms")
    return out


def _launch_name(name):
    """A profiled launch's name without its namespace and arguments."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0][:60]


# The runs path's own device work: its kernels and its memsets.
RUNS_KERNELS = ("sort_hist_kernel", "sort_pass_kernel", "run_heads_kernel",
                "run_chunks_kernel")


def runs_breakdown(calls, reps=5):
    """Each runs-path call {label: (ct, idx, k)} `reps` times in one
    torch.profiler session (a later session on the card may record no
    device time), its device launches attributed to the call's range by
    the host time of their launch calls: {label: {device_us, launches: [{name,
    per_call, us}]}}, or {} where the profiler saw no device time.
    Checks that every launch is one of RUNS_KERNELS or a memset: no
    library sort."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from sunray_tpu_torch.ops import cuda_gather

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # Outside every range: a later session in a process lost its
        # first calls' device events (phase 11 after phase 6's).
        for c in calls.values():
            cuda_gather.gather_rows_bwd(*c)
        torch.cuda.synchronize()
        for label, c in calls.items():
            with record_function(f"runs {label}"):
                for _ in range(reps):
                    cuda_gather.gather_rows_bwd(*c)
                torch.cuda.synchronize()
    path = os.path.join(REPO, "build", "phase11", "runs_profile.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"][5:]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("runs ")}
    # A launch's host time, by its correlation id: a device event is
    # attributed to the range its launch call lies in.
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {}
    for label, (lo, hi) in ranges.items():
        per = {}
        for e in events:
            at = launched.get(e.get("args", {}).get("correlation"), e.get("ts"))
            if (e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
                    and lo <= at <= hi):
                n, us = per.get(e["name"], (0, 0.0))
                per[e["name"]] = (n + 1, us + e["dur"])
        if not per:
            continue
        rows = sorted(((name, n / reps, us / n) for name, (n, us)
                       in per.items()), key=lambda r: -r[1] * r[2])
        total = sum(a * b for _, a, b in rows)
        whole = all(n % reps == 0 for n, _ in per.values())
        log(f"  runs path, {label}"
            + ("" if whole else " (the profiler missed launches)")
            + f": {total:.1f} us of device time a call in "
            f"{sum(a for _, a, _ in rows):.0f} launches: "
            + "; ".join(f"{a:g} x {us:.2f} us {_launch_name(name)}"
                        for name, a, us in rows))
        for name, _, _ in rows:
            check(name.startswith("Memset") or any(
                k in name for k in RUNS_KERNELS),
                f"runs path {label}: launch {name} is not the port's")
        out[label] = dict(device_us=total, every_call_seen=whole, launches=[
            dict(name=_launch_name(name), per_call=a, us=us)
            for name, a, us in rows])
    if not out:
        log("  runs path launch breakdown: not measured (the profiler "
            "recorded no device time)")
    return out


def bwd_label(call, rows_of):
    """A K8-backward call's label: its table's name in rows_of (by rows),
    else its table's shape."""
    ct, _, k = call
    return rows_of.get(k, f"{k} x {ct.shape[1]} table")


def grad_nans(grads):
    return {name: (None if g is None else int(torch.isnan(g).sum()))
            for name, g in zip(REAL_DIFF_PARAMS, grads)}


def real_diff_step_run(dev, path):
    """The 720p differentiable step on the phase-10 GLB ("auto": B3,
    default ReSTIR, the four leaves): the launch check of one step with
    its K8-backward calls captured, one step with edge antialiasing for
    the triangle table's call, K8's backward held on every one of those
    calls (both paths) and the runs path timed on the calls above
    MAX_ROWS rows, then REAL_DIFF_WARM warm-up and REAL_DIFF_TIMED
    timed steps (synced) with the peak memory, each kernel's launches a
    step and each gradient's NaN count. Returns (the runs path's row,
    launches of the launch-check step)."""
    import dataclasses

    from sunray_tpu_torch.ops import cuda_build, cuda_gather
    from sunray_tpu_torch.render.pipeline import RenderState

    w, h = DIFF_SIZE
    cfg, scene, leaves, mats, accel = real_diff_setup(dev, path, w, h,
                                                      tracer="auto")
    log(f"phase 11: {w}x{h} differentiable step on the phase-10 GLB "
        f"({scene.num_tris} triangles, {scene.positions.shape[0]} vertex "
        f"rows, atlas {tuple(scene.textures.data.shape)}, "
        f"{scene.inst_transform.shape[0]} instances, "
        f"{scene.materials.base_color.shape[0]} materials; accel "
        f"{type(accel).__name__}), ReSTIR, leaves {REAL_DIFF_PARAMS}")
    state = RenderState.create(cfg, dev)
    torch.cuda.synchronize()
    cuda_build.launches.clear()
    (state, loss, grads, aux), calls = capture_bwd_calls(
        lambda: real_diff_step(cfg, scene, leaves, mats, state, accel))
    torch.cuda.synchronize()
    launches = dict(cuda_build.launches)
    log(f"  launches in one step: {launches}")
    for name in REAL_DIFF_KERNELS:
        check(launches.get(name, 0) > 0, f"real-scene step: {name} never "
              "launched")
    for name in DIFF_ABSENT + ("trace_closest", "trace_occluded", "bvh_walk"):
        check(launches.get(name, 0) == 0, f"real-scene step: {name} launched")
    big = [c for c in calls if c[2] > cuda_gather.MAX_ROWS]
    check(launches.get("gather_rows_bwd_runs", 0) == len(big)
          and launches.get("gather_rows_bwd", 0) == len(calls) - len(big),
          f"K8 backward launches {launches} for calls "
          f"{[(tuple(c[1].shape), c[2]) for c in calls]}")
    aa_cfg = dataclasses.replace(cfg, edge_antialias=True)
    _, aa_calls = capture_bwd_calls(lambda: real_diff_step(
        aa_cfg, scene, leaves, mats, RenderState.create(cfg, dev), accel))
    tri_rows = scene.num_tris
    aa = [c for c in aa_calls if c[2] == tri_rows]
    check(len(aa) == 1, f"edge AA: calls {[(tuple(c[1].shape), c[2]) for c in aa_calls]}")
    del aa_calls
    rows_of = {scene.positions.shape[0]: "corners",
               int(np.prod(scene.textures.data.shape[:3])): "texels",
               tri_rows: "edge AA"}
    labelled = [(bwd_label(c, rows_of), c) for c in calls + aa]
    worst, worst_plain, worst_abs, exact = k8_bwd_hold(labelled)
    timed = {}
    firsts = {}
    for lab, c in labelled:
        if c[2] > cuda_gather.MAX_ROWS and lab not in timed:
            timed[lab] = runs_timing(lab, c, dev)
            firsts[lab] = c
    breakdown = runs_breakdown(firsts)
    del calls, big, aa, labelled, firsts
    for _ in range(REAL_DIFF_WARM - 1):
        state, loss, grads, aux = real_diff_step(cfg, scene, leaves, mats,
                                                 state, accel)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    for _ in range(REAL_DIFF_TIMED):
        state, loss, grads, aux = real_diff_step(cfg, scene, leaves, mats,
                                                 state, accel)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / REAL_DIFF_TIMED
    per_step = {k: v / REAL_DIFF_TIMED for k, v in cuda_build.launches.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nans = grad_nans(grads)
    log(f"  step {step_s * 1e3:.3f} ms (mean of {REAL_DIFF_TIMED} after "
        f"{REAL_DIFF_WARM} warm-up, synced); loss {float(loss):.6f}; peak "
        f"memory {peak_gb:.3f} GB (limit {VIS_PEAK_GB}); NaN entries of each "
        f"gradient {nans}; launches a step {per_step}")
    check(math.isfinite(float(loss)), "real-scene step: non-finite loss")
    check(peak_gb <= VIS_PEAK_GB, f"real-scene step: peak memory {peak_gb} "
          f"GB > {VIS_PEAK_GB}")
    check(all(g is not None for g in grads), "real-scene step: a leaf "
          "without gradient")
    main = timed["texels"]
    row = dict(max_abs_err=worst_abs, err_over_row_abs_sum=worst,
               err_over_row_abs_sum_vs_plain=worst_plain,
               bit_equal_runs=exact, ms=main["ms"], plain_ms=main["plain_ms"],
               library_ms=main["library_ms"],
               index_put_ms=main["index_put_ms"], sort_ms=main["sort_ms"],
               hand_sort_ms=main["hand_sort_ms"], breakdown=breakdown,
               bound=main["bound"], shape=main["shape"],
               calls={lab: {k: v for k, v in t.items() if k != "bound"}
                      | {"bound_ms": t["bound"][0]} for lab, t in timed.items()},
               step_ms=step_s * 1e3, step_peak_gb=peak_gb,
               step_launches=per_step, step_nans=nans)
    return row, launches


def big_diff_step(dev):
    """One 720p differentiable step of the big mesh (BIG_SUBDIV, binned,
    default ReSTIR) w.r.t. positions and base_color, after one warm-up
    whose K8-backward calls are held against the plain version
    (k8_bwd_hold): synced ms, peak memory, the launch check, NaN
    counts."""
    import dataclasses

    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.render.pipeline import RenderState

    w, h = DIFF_SIZE
    cfg = RenderConfig(width=w, height=h, differentiable=True)
    sc = big_scene(dev)
    accel = big_accel(sc, cfg)
    leaves = (sc.positions.clone().requires_grad_(),
              sc.materials.base_color.clone().requires_grad_())
    scene = dataclasses.replace(
        sc, positions=leaves[0],
        materials=dataclasses.replace(sc.materials, base_color=leaves[1]))
    mats = camera_matrices(Camera(**CAMERA), w, h, device=dev)
    state = RenderState.create(cfg, dev)
    (state, _, _, _), calls = capture_bwd_calls(
        lambda: real_diff_step(cfg, scene, leaves, mats, state, accel))
    log(f"phase 11: {w}x{h} differentiable big-mesh step, K8's backward on "
        "the warm-up step's calls")
    held = k8_bwd_hold([(bwd_label(c, {sc.positions.shape[0]: "corners"}), c)
                        for c in calls])
    del calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    t0 = time.perf_counter()
    state, loss, grads, _ = real_diff_step(cfg, scene, leaves, mats, state,
                                           accel)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(cuda_build.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nans = {name: int(torch.isnan(g).sum()) for name, g in
            zip(("positions", "base_color"), grads)}
    log(f"phase 11: {w}x{h} differentiable big-mesh step ({sc.num_tris} "
        f"triangles, {sc.positions.shape[0]} vertex rows, binned): "
        f"{step_ms:.3f} ms (one step after one warm-up, synced); loss "
        f"{float(loss):.6f}; peak memory {peak_gb:.3f} GB; NaN entries "
        f"{nans}; launches {launches}")
    for name in BIG_DIFF_KERNELS:
        check(launches.get(name, 0) > 0, f"big-mesh step: {name} never "
              "launched")
    for name in DIFF_ABSENT + ("trace_closest", "trace_occluded"):
        check(launches.get(name, 0) == 0, f"big-mesh step: {name} launched")
    check(math.isfinite(float(loss)), "big-mesh step: non-finite loss")
    check(peak_gb <= VIS_PEAK_GB, f"big-mesh step: peak {peak_gb} GB")
    return dict(step_ms=step_ms, peak_gb=peak_gb, nans=nans,
                launches=launches, bwd_err_over_row_abs_sum=held[0],
                bwd_err_over_row_abs_sum_vs_plain=held[1],
                bwd_bit_equal_runs=held[3])


def phase_real_diff(dev):
    """Phase 11, differentiable real scenes: (a) the small GLB card vs CPU,
    (b) + (c) the 720p step on the phase-10 GLB with the runs path held
    and timed on its own calls, (d) the big mesh's 720p step. Returns
    (the runs path's row, launches of the launch-check step)."""
    t_phase = time.perf_counter()
    card_cpu = real_diff_card_vs_cpu(dev)
    row, launches = real_diff_step_run(dev, real_scene_path())
    row["card_vs_cpu"] = card_cpu
    row["big_mesh_step"] = big_diff_step(dev)
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return row, launches


# -- phase 12: the configurations (samples, per-pixel taps, bf16, many lights)

RESTIR_NAMES = ("ris_audition", "di_temporal", "di_spatial", "gi_spatial")
# The bf16 instantiations of K3-K6 (csrc/restir.cu, counted under these
# names by ops/cuda_restir.py).
BF16_NAMES = tuple(f"{k}_bf16" for k in RESTIR_NAMES)
CONFIG_KW = {
    "samples4": dict(samples=4),
    "perpixel": dict(spatial_taps="perpixel"),
    "bf16": dict(shading_dtype="bf16"),
    # Brute force on both devices: "auto" would trace the 612 triangles
    # with an LBVH on the CPU (its brute limit is 512) and brute force on
    # the card, and the two tracers break ties apart.
    "lights578": dict(tracer="brute"),
}
MANY_PANELS = 17            # cornell_box_many_lights(17): 578 lights
CONFIG_WARM, CONFIG_TIMED = 2, 3
CONFIG_SMALL_FRAMES = 3     # card vs CPU at the golden size
# K3-K6's attribute planes by wrapper, as (first, last + 1) positional
# indices: normal, view, albedo, roughness, metallic (K6: normal, albedo,
# metallic, and its bf16 ones ride the `shade` keyword).
ATTR_ARGS = {"ris_audition": (3, 8), "di_temporal": (7, 12),
             "di_spatial": (9, 14), "gi_spatial": (5, 8)}


def config_scene(name, device):
    from sunray_tpu_torch.scene import cornell_box, cornell_box_many_lights

    if name == "lights578":
        return cornell_box_many_lights(MANY_PANELS, device=device)
    return cornell_box(device=device)


def config_render(name, cfg, device, frames):
    """ldr after `frames` frames of config `name`'s scene."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame

    scene = config_scene(name, device)
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                           device=device)
    state = RenderState.create(cfg, device)
    ldr = None
    for _ in range(frames):
        state, ldr, _ = render_frame(scene, cfg, state, mats)
    return ldr


def config_frame(dev, name, width=1920, height=1080):
    """Config `name`'s 1080p ReSTIR frame: CONFIG_WARM + CONFIG_TIMED
    frames with the launch counts zeroed just before and read just after,
    frame ms over the timed ones, rays a frame. Returns (launches, ms,
    rays a frame, frames run)."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build, cuda_trace
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame

    cfg = RenderConfig(width=width, height=height, lighting="restir",
                       **CONFIG_KW[name])
    scene = config_scene(name, dev)
    mats = camera_matrices(Camera(**CAMERA), width, height, device=dev)
    state = RenderState.create(cfg, dev)
    torch.cuda.synchronize()
    cuda_build.launches.clear()
    cuda_trace.rays.clear()
    for _ in range(CONFIG_WARM):
        state, ldr, aux = render_frame(scene, cfg, state, mats)
    torch.cuda.synchronize()
    rays0 = sum(cuda_trace.rays.values())
    t0 = time.perf_counter()
    for _ in range(CONFIG_TIMED):
        state, ldr, aux = render_frame(scene, cfg, state, mats)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / CONFIG_TIMED * 1e3
    launches = dict(cuda_build.launches)
    rays = (sum(cuda_trace.rays.values()) - rays0) / CONFIG_TIMED
    ldr_np = ldr.cpu().numpy()
    check(ldr_np.shape == (height, width, 3), f"{name}: ldr {ldr_np.shape}")
    check(bool(np.isfinite(ldr_np).all()), f"{name}: non-finite ldr")
    check(0.05 < float(ldr_np.mean()) < 0.95, f"{name}: ldr mean "
          f"{ldr_np.mean()}")
    frames = CONFIG_WARM + CONFIG_TIMED
    log(f"  {name}: {scene.num_lights} lights, frame {ms:.3f} ms (mean of "
        f"{CONFIG_TIMED} after {CONFIG_WARM}), rays/frame {rays:.0f}, walk "
        f"rounds final {aux['final_rounds']}; launches over {frames} frames: "
        f"{launches}")
    return launches, ms, rays, frames


def with_f32_attrs(name, args, kwargs):
    """K3-K6's bf16 arguments with the attribute planes widened to float32
    (exactly): the fp32 instantiation's arguments on the same data."""
    a, b = ATTR_ARGS[name]
    args = list(args)
    if name != "gi_spatial":
        args[a:b] = [x.float().contiguous() for x in args[a:b]]
    return tuple(args), {}


def bf16_rows(dev, launches, frames):
    """K3-K6's bf16 instantiations on frame 2's own inputs of the 1080p
    bf16 ReSTIR frame: each against its plain version, timed (device_ms)
    beside the fp32 instantiation on the same data widened, its plain
    version, and its bound with the attribute planes at 2 bytes."""
    from sunray_tpu_torch.ops import cuda_restir

    calls = capture_calls(dev, dict.fromkeys(RESTIR_NAMES, "cuda_restir"), 2,
                          lighting="restir", shading_dtype="bf16")
    rows = {}
    for name in RESTIR_NAMES:
        check(len(calls[name]) == 1, f"bf16 frame 2: {len(calls[name])} "
              f"{name} calls")
        args, kwargs = calls[name][0]
        attrs = args[ATTR_ARGS[name][0]:ATTR_ARGS[name][1]]
        if name == "gi_spatial":
            attrs = kwargs["shade"]
        check(all(x.dtype == torch.bfloat16 for x in attrs),
              f"{name}: the bf16 frame's attributes are not bf16")
        agree, err = compare_restir(name, args, "bf16, 1080p frame 2",
                                    kwargs)
        fn = getattr(cuda_restir, name)
        out = fn(*args, **kwargs)
        f32_args, f32_kwargs = with_f32_attrs(name, args, kwargs)
        lanes = (args[0] if name == "gi_spatial" else args[1]).shape[0]
        r = dict(
            bf16_agree=agree, bf16_max_abs_err=err,
            bf16_ms=device_ms(lambda: fn(*args, **kwargs)),
            bf16_f32_same_data_ms=device_ms(lambda: fn(*f32_args,
                                                        **f32_kwargs)),
            bf16_plain_ms=time_ms(lambda: getattr(
                cuda_restir, RESTIR_WRAPPERS[name])(*args, **kwargs)),
            bf16_launches_a_frame=launches.get(f"{name}_bf16", 0) / frames)
        b = bound(nbytes(*flatten(args), *flatten(kwargs))
                  + nbytes(*flatten(out)), lanes * restir_lane_ops(name, args))
        r["bf16_bound_ms"], r["bf16_bound_by"] = b
        log(f"  time {name} bf16: kernel {r['bf16_ms']:.4f} ms (fp32 "
            f"instantiation on the same data {r['bf16_f32_same_data_ms']:.4f}), "
            f"plain {r['bf16_plain_ms']:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); "
            f"{r['bf16_launches_a_frame']:g} launches a frame")
        rows[name] = r
    return rows


def lights578_k3(dev):
    """K3 on the 578-light table of cornell_box_many_lights(17): frame 2's
    own audition call of the 1080p frame, against plain, timed."""
    from sunray_tpu_torch.ops import cuda_restir

    calls = capture_calls(dev, {"ris_audition": "cuda_restir"}, 2,
                          scene=config_scene("lights578", dev),
                          lighting="restir")["ris_audition"]
    check(len(calls) == 1, f"578-light frame 2: {len(calls)} K3 calls")
    args = calls[0][0]
    check(args[0].num == 2 * MANY_PANELS ** 2, f"{args[0].num} lights")
    agree, err = compare_restir("ris_audition", args,
                                f"{args[0].num}-light table, 1080p frame 2")
    ms = device_ms(lambda: cuda_restir.ris_audition(*args))
    log(f"  K3 on the {args[0].num}-light table: {ms:.4f} ms")
    return dict(lights578_agree=agree, lights578_max_abs_err=err,
                lights578_ms=ms)


def quality_cases(dev):
    """tests/test_torch_quality.py's cases on the card: each case's mean
    raw HDR and last LDR against the converged truth, under the ledger's
    bounds (tests/torch_quality_cases.py)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_quality_cases import CASES, run_case, score

    out = {}
    for name in sorted(CASES):
        mean_raw, ldr = run_case(name, dev)
        check(bool(np.isfinite(mean_raw).all() and np.isfinite(ldr).all()),
              f"quality {name}: non-finite output")
        r, p, r_max, p_min = score(name, mean_raw, ldr)
        log(f"  quality {name}: relMSE {r:.4f} (bound {r_max:.4f}), LDR "
            f"PSNR {p:.2f} dB (bound {p_min:.2f})")
        check(r < r_max, f"quality {name}: relMSE {r:.4f} > {r_max:.4f}")
        check(p > p_min, f"quality {name}: PSNR {p:.2f} < {p_min:.2f}")
        out[name] = dict(relmse=r, psnr=p)
    return out


def phase_configs(dev, kernels):
    """Phase 12: the frame configurations (1080p on the Cornell camera):
    ReSTIR with samples=4, with per-pixel taps, with bf16 shading (K3-K6's
    bf16 instantiations held to plain on the frame's own inputs and
    timed), on the 578-light box (K3 on its table); each config's card
    frame against the CPU at the golden size; the four quality cases
    against their truths. Adds the bf16 and 578-light numbers to kernels'
    K3-K6 rows; returns the phase's summary."""
    from sunray_tpu_torch.config import RenderConfig

    t_phase = time.perf_counter()
    summary = {}
    for name in CONFIG_KW:
        log(f"phase 12: 1920x1080 Cornell frame, {name}")
        launches, ms, rays, frames = config_frame(dev, name)
        summary[name] = dict(frame_ms=ms, rays_a_frame=rays,
                             launches_a_frame={k: v / frames for k, v in
                                               launches.items()})
        want = ("trace_closest", "trace_occluded", "gather_rows")
        if name == "bf16":
            want += BF16_NAMES
            for k in RESTIR_NAMES:
                check(launches.get(k, 0) == 0, f"bf16 frame: fp32 {k} "
                      f"launched {launches.get(k, 0)} times")
        elif name == "perpixel":
            # per-pixel taps run plain in both packages (pathtrace.py:
            # 722-725): K5 and K6 stay idle.
            want += ("ris_audition", "di_temporal")
            for k in ("di_spatial", "gi_spatial"):
                check(launches.get(k, 0) == 0, f"perpixel frame: {k} launched")
        else:
            want += RESTIR_NAMES
        for k in want:
            check(launches.get(k, 0) > 0, f"{name} frame: {k} never launched")
        if name == "samples4":
            for k in ("di_spatial", "gi_spatial"):
                check(launches[k] == 4 * frames,
                      f"samples=4: {k} launched {launches[k]} times in "
                      f"{frames} frames")
            check(launches["trace_closest"] == 2 * frames,
                  f"samples=4: K1 launched {launches['trace_closest']} times")
        if name == "bf16":
            for k, r in bf16_rows(dev, launches, frames).items():
                kernels[k].update(r)
        if name == "lights578":
            kernels["ris_audition"].update(lights578_k3(dev))

    for name in CONFIG_KW:
        log(f"phase 12: {name} golden-size config, {CONFIG_SMALL_FRAMES} "
            "frames, card vs CPU")
        cfg = RenderConfig(**dict(GOLDEN_KW, lighting="restir",
                                  **CONFIG_KW[name]))
        gpu = config_render(name, cfg, dev, CONFIG_SMALL_FRAMES).cpu().numpy()
        cpu = config_render(name, cfg, "cpu", CONFIG_SMALL_FRAMES).numpy()
        p = psnr(gpu, cpu)
        log(f"  PSNR card vs CPU {p:.2f} dB")
        check(p > PSNR_MIN, f"{name}: card vs CPU PSNR {p:.2f} dB")
        summary[name]["card_vs_cpu_psnr"] = p
    log("phase 12: the quality cases at 128x72 on the card against their "
        "converged truths")
    summary["quality"] = quality_cases(dev)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return summary


# -- phase 13: the bf16 differentiable step, JPEG, packing, checkpoints,
# provenance, profiling and the roofline -------------------------------------

BF16_STEP_WARM, BF16_STEP_TIMED = 2, 3  # the first warm-up step is the
                                        # launch check
BF16_SMALL, BF16_SMALL_STEPS = (32, 24), 2      # card vs CPU
JPEGS = ("web_viewer_frame.jpg", "web_viewer_spawned.jpg")
# SHA-256 of the RGBA pixels PIL 12.1.0 (libjpeg-turbo) decodes from each
# (tests/test_torch_jpeg.py holds the port's decoder to PIL and to these).
JPEG_SHA256 = {
    "web_viewer_frame.jpg":
        "e94f9e31b4ba42ef3e811a50f8c00f68b0b2e00c58275f6ce8f0733adf6eb4b4",
    "web_viewer_spawned.jpg":
        "25936acc50ad4d44c6e983a96e7443335eb20e20e19e9059f6e57669b913dc2f",
}
JPEG_GLTF = dict(width=96, height=64)
JPEG_GLTF_FRAMES = 2
PACK_N = 2_000_000
CKPT_FRAMES = 3
CKPT_SIZE = (1920, 1080)
PROFILE_TOP = 10
# exec_paths' stages and the launch counters of their kernels.
STAGE_COUNTERS = {"ris_audition": "ris_audition",
                  "di_temporal": "di_temporal", "di_spatial": "di_spatial",
                  "gi_spatial": "gi_spatial", "denoise": "atrous_pass",
                  "taa": "taa_clamp_blend", "history": "history_gather"}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bf16_step(dev, f32_step_ms):
    """The 720p differentiable ReSTIR step of phase 8 with bf16 shading:
    the launch check of one step (K1, K2, K8 and K8's backward launch;
    K3-K7, K9, K13 and K3-K6's bf16 instantiations do not), then
    BF16_STEP_TIMED timed steps after BF16_STEP_WARM; then the frame at
    BF16_SMALL card vs CPU, BF16_SMALL_STEPS steps, phase 8's bars and
    NaN masks equal."""
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.render.pipeline import RenderState

    w, h = DIFF_SIZE
    log(f"phase 13: {w}x{h} differentiable ReSTIR step, shading_dtype='bf16'")
    cfg, scene, leaves, mats = diff_setup(dev, w, h, shading_dtype="bf16")
    state = RenderState.create(cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.launches.clear()
    state, loss, grads, aux = diff_step(cfg, scene, leaves, mats, state)
    torch.cuda.synchronize()
    launches = dict(cuda_build.launches)
    log(f"  launches in one step: {launches}")
    for name in ("trace_closest", "trace_occluded", "gather_rows_bwd"):
        check(launches.get(name, 0) > 0, f"bf16 step: {name} never launched")
    check(launches.get("gather_rows", 0) + launches.get("gather_rows_multi", 0)
          > 0, "bf16 step: K8 never launched")
    for name in DIFF_ABSENT + BF16_NAMES:
        check(launches.get(name, 0) == 0, f"bf16 step: {name} launched")
    for _ in range(BF16_STEP_WARM - 1):
        state, loss, grads, aux = diff_step(cfg, scene, leaves, mats, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BF16_STEP_TIMED):
        state, loss, grads, aux = diff_step(cfg, scene, leaves, mats, state)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / BF16_STEP_TIMED * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    g_norms = [float(g.norm()) for g in grads]
    f32 = ("not measured in this run" if f32_step_ms is None
           else f"{f32_step_ms:.3f} ms")
    log(f"  step {step_ms:.3f} ms (mean of {BF16_STEP_TIMED} after "
        f"{BF16_STEP_WARM} warm-up; phase 8's float32 step {f32}); peak "
        f"memory {peak_gb:.3f} GB; loss {float(loss):.6f}; "
        f"|grad base_color| {g_norms[0]:.6f}, |grad positions| "
        f"{g_norms[1]:.6f}")
    check(math.isfinite(float(loss)) and all(map(math.isfinite, g_norms)),
          "bf16 step: non-finite loss or gradient")
    check(g_norms[1] > 0.0, "bf16 step: zero positions gradient")

    kw = {k: v for k, v in GOLDEN_KW.items() if k not in ("width", "height",
                                                         "lighting")}
    log(f"phase 13: bf16 differentiable frame {BF16_SMALL[0]}x"
        f"{BF16_SMALL[1]}, {BF16_SMALL_STEPS} steps, card vs CPU")
    card = diff_run(dev, BF16_SMALL_STEPS, *BF16_SMALL, shading_dtype="bf16",
                    **kw)
    cpu = diff_run("cpu", BF16_SMALL_STEPS, *BF16_SMALL, shading_dtype="bf16",
                   **kw)
    worst = 0.0
    for i, ((lg, gg), (lc, gc)) in enumerate(zip(card, cpu)):
        rel = abs(float(lg) - float(lc)) / abs(float(lc))
        check(rel <= DIFF_LOSS_RTOL, f"bf16 step {i}: card vs CPU loss rel "
              f"{rel}")
        for name, a, b in zip(("base_color", "positions"), gg, gc):
            check(torch.equal(torch.isnan(a), torch.isnan(b)),
                  f"bf16 step {i}: {name} NaN masks differ")
            ok, d = grads_close(torch.nan_to_num(a), torch.nan_to_num(b))
            check(ok, f"bf16 step {i}: {name} gradient card vs CPU ({d:.2e})")
            worst = max(worst, d)
        log(f"  step {i}: loss card {float(lg):.7f} CPU {float(lc):.7f} "
            f"(rel {rel:.2e})")
    log(f"  largest gradient difference over the largest |g|: {worst:.2e}")
    return dict(step_ms=step_ms, peak_gb=peak_gb, f32_step_ms=f32_step_ms,
                launches={k: launches.get(k, 0) for k in
                          ("trace_closest", "trace_occluded", "gather_rows",
                           "gather_rows_multi", "gather_rows_bwd")},
                card_vs_cpu_grad=worst), cfg


def jpeg_checks(dev):
    """Decode the repo's JPEGs (seconds, pixels' SHA-256 against PIL's);
    render a tools/synth_gltf.py document whose images are those JPEGs
    through the Renderer on the card and on the CPU port at JPEG_GLTF,
    PSNR above PSNR_MIN each frame. Returns (summary, the card frames'
    launches, their config, the scene's light count)."""
    import hashlib

    from sunray_tpu_torch.camera import Camera
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.render.renderer import Renderer
    from sunray_tpu_torch.utils.jpeg import read_jpeg_rgba
    from tools.synth_gltf import CAMERA as REAL_CAMERA
    from tools.synth_gltf import write_jpeg_scene

    out = {}
    paths = [os.path.join(REPO, "docs", "renders", n) for n in JPEGS]
    for name, path in zip(JPEGS, paths):
        t0 = time.perf_counter()
        img = read_jpeg_rgba(path)
        dt = time.perf_counter() - t0
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        log(f"phase 13: {name} {img.shape[1]}x{img.shape[0]} decoded in "
            f"{dt:.3f} s, SHA-256 {digest[:16]}...")
        check(digest == JPEG_SHA256[name], f"{name}: pixels differ from PIL's")
        out[f"decode_s_{name}"] = dt
    gltf = os.path.join(REPO, "build", "phase13", "jpeg.gltf")
    os.makedirs(os.path.dirname(gltf), exist_ok=True)
    write_jpeg_scene(gltf, paths)
    cfg = RenderConfig(**JPEG_GLTF)
    cam = Camera(**REAL_CAMERA)
    frames = []
    for device in (dev, torch.device("cpu")):
        r = Renderer(cfg, device=device)
        t0 = time.perf_counter()
        r.load_gltf(gltf)
        sync(device)
        load_s = time.perf_counter() - t0
        cuda_build.launches.clear()
        frames.append([r.render(cam).cpu().numpy()
                       for _ in range(JPEG_GLTF_FRAMES)])
        if device is dev:
            launches = dict(cuda_build.launches)
            n_lights = int(r.scene.num_lights)
            out["load_gltf_s"] = load_s
    p = [psnr(a, b) for a, b in zip(*frames)]
    log(f"phase 13: JPEG-textured glTF {cfg.width}x{cfg.height}, "
        f"{JPEG_GLTF_FRAMES} frames card vs CPU: PSNR "
        f"{[round(x, 2) for x in p]} dB; load_gltf on the card "
        f"{out['load_gltf_s']:.3f} s; launches {launches}")
    check(min(p) > PSNR_MIN, f"JPEG glTF: card vs CPU PSNR {min(p):.2f} dB")
    out["card_vs_cpu_psnr"] = p
    return out, launches, cfg, n_lights


def packing_checks(dev):
    """ops/packing.py on the card against the CPU port, bit-equal, on
    PACK_N seeded values (and PACK_N seeded words for the unpacks)."""
    from sunray_tpu_torch.ops import packing

    gen = torch.Generator().manual_seed(13)
    v = torch.rand((PACK_N, 4), generator=gen) * 4.0 - 2.0
    v[:8] = torch.tensor([0.0, -0.0, 1.0, -1.0, 0.5 / 32767, 65520.0,
                          float("inf"), float("nan")])[:, None]
    n = torch.randn((PACK_N, 3), generator=gen)
    n = n / n.norm(dim=-1, keepdim=True)
    words = torch.randint(-2 ** 31, 2 ** 31, (PACK_N,), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    cases = [("pack_snorm_2x16", v[:, :2]), ("pack_unorm_4x8", v),
             ("pack_half_2x16", v[:, :2]), ("pack_normal", n),
             ("unpack_snorm_2x16", words), ("unpack_unorm_4x8", words),
             ("unpack_half_2x16", words), ("unpack_normal", words)]
    t0 = time.perf_counter()
    for name, x in cases:
        fn = getattr(packing, name)
        card, cpu = fn(x.to(dev)).cpu(), fn(x)
        if card.dtype == torch.float32:
            card, cpu = card.view(torch.int32), cpu.view(torch.int32)
        check(torch.equal(card, cpu), f"packing: {name} card vs CPU differ on "
              f"{int((card != cpu).sum())} values")
    log(f"phase 13: packing, {len(cases)} functions on {PACK_N} values, card "
        f"bit-equal to the CPU port ({time.perf_counter() - t0:.2f} s)")


def checkpoint_checks(dev):
    """The 1080p default ReSTIR state after CKPT_FRAMES frames saved and
    loaded (utils/checkpoint.py); the next frame from each bit-equal.
    Returns (summary, scene, cfg, state, mats, the frames' launches)."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box
    from sunray_tpu_torch.utils import checkpoint

    cfg = RenderConfig(width=CKPT_SIZE[0], height=CKPT_SIZE[1])
    scene = cornell_box(device=dev)
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                           device=dev)
    state = RenderState.create(cfg, dev)
    sync(dev)
    cuda_build.launches.clear()
    for _ in range(CKPT_FRAMES):
        state, _, _ = render_frame(scene, cfg, state, mats)
    sync(dev)
    launches = dict(cuda_build.launches)
    path = os.path.join(REPO, "build", "phase13", "state.npz")
    t0 = time.perf_counter()
    checkpoint.save_state(state, path)
    save_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    loaded = checkpoint.load_state(path, RenderState.create(cfg, dev))
    sync(dev)
    load_s = time.perf_counter() - t0
    s1, ldr1, _ = render_frame(scene, cfg, state, mats)
    s2, ldr2, _ = render_frame(scene, cfg, loaded, mats)
    check(torch.equal(ldr1, ldr2), "checkpoint: resumed frame differs")
    for a, b in zip(checkpoint._leaves(s1), checkpoint._leaves(s2)):
        check(torch.equal(a, b), "checkpoint: resumed state differs")
    log(f"phase 13: checkpoint of the {cfg.width}x{cfg.height} ReSTIR state "
        f"after {CKPT_FRAMES} "
        f"frames: save {save_s:.3f} s, load {load_s:.3f} s, {mb:.1f} MB; "
        "the next frame bit-equal from both")
    os.remove(path)
    return (dict(save_s=save_s, load_s=load_s, mb=mb), scene, cfg, state,
            mats, launches)


def provenance_check(label, cfg, num_lights, launches, frames=1):
    """exec_paths(cfg) against the launch counters of the frames it names:
    a "cuda" stage launched its kernel, a "plain" or "off" one none (a
    bf16 frame's K3-K6 count under their bf16 names)."""
    from sunray_tpu_torch.utils.provenance import exec_paths

    paths = exec_paths(cfg, num_lights)
    bf16 = cfg.shading_dtype == "bf16"
    for stage, counter in STAGE_COUNTERS.items():
        if bf16 and counter in RESTIR_NAMES:
            counter += "_bf16"
        n = launches.get(counter, 0)
        if paths[stage] == "cuda":
            check(n > 0, f"provenance, {label}: {stage} is 'cuda' but "
                  f"{counter} never launched")
        else:
            check(n == 0, f"provenance, {label}: {stage} is "
                  f"{paths[stage]!r} but {counter} launched {n} times")
    log(f"  {label}: " + ", ".join(f"{k} {paths[k]}" for k in STAGE_COUNTERS)
        + f" (launches over {frames} frame(s) agree)")
    return paths


def profiling_checks(scene, cfg, state, mats, phase5):
    """stage_timings of the 1080p ReSTIR frame; one profiled frame
    (device_trace) summarised: its top PROFILE_TOP device rows and the
    device's idle share; roofline_report with phase 5's frame ms."""
    from sunray_tpu_torch.render.pipeline import render_frame
    from sunray_tpu_torch.utils import profiling, roofline

    t = profiling.stage_timings(scene, cfg, state, mats, repeats=5)
    log(f"phase 13: stage_timings, {cfg.width}x{cfg.height} ReSTIR frame, "
        "ms: " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in t.items()))
    log_dir = os.path.join(REPO, "build", "phase13", "trace")
    with profiling.device_trace(log_dir):
        t0 = time.perf_counter()
        render_frame(scene, cfg, state, mats)
        sync(scene.positions.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    log(f"phase 13: one profiled frame ({wall_ms:.3f} ms wall, profiler on), "
        f"top {PROFILE_TOP} device rows:")
    rows = profiling.summarize_trace(log_dir, top=PROFILE_TOP, steady_frac=1.0)
    busy = profiling.device_busy(log_dir)
    log(f"  device busy {busy['busy_ms']:.3f} ms of {busy['span_ms']:.3f} ms "
        f"from its first to its last event (idle {busy['idle_share']:.1%}); "
        f"{sum(r['count'] for r in rows)} device events "
        f"({', '.join(busy['categories'])})")
    # The rows must be the card's events: a trace whose device events were
    # lost raises in summarize_trace, and one read as a CPU trace fails
    # here.
    check(busy["device"] == "cuda"
          and set(busy["categories"]) <= set(profiling.DEVICE_CATS)
          and "kernel" in busy["categories"],
          f"profile: rows read from {busy['device']} events "
          f"{busy['categories']}, not the card's kernels")
    check(rows and busy["busy_ms"] > 0.0, "profile: no device time recorded")
    rep = roofline.roofline_report(cfg, measured_ms=phase5["frame_ms"],
                                   ris_rounds=phase5["ris_rounds"],
                                   final_rounds=phase5["final_rounds"])
    log(f"phase 13: roofline of the {cfg.width}x{cfg.height} ReSTIR frame at "
        f"phase 5's {phase5['frame_ms']:.3f} ms: " + json.dumps(rep))
    return dict(stage_timings_ms={k: v * 1e3 for k, v in t.items()},
                top_rows=[dict(r, name=r["name"][:80])
                          for r in rows[:PROFILE_TOP]],
                busy=busy, roofline=rep)


def phase_utilities(dev, f32_step_ms, phase5, frames):
    """Phase 13. f32_step_ms: phase 8's step (None: not measured); phase5:
    phase_main's record of the 1080p ReSTIR frame; frames: {label: (cfg,
    num_lights, launches, frames)} of the earlier phases' frames whose
    exec_paths it checks."""
    t_phase = time.perf_counter()
    summary = {}
    summary["bf16_step"], bf16_cfg = bf16_step(dev, f32_step_ms)
    summary["jpeg"], jpeg_launches, jpeg_cfg, jpeg_lights = jpeg_checks(dev)
    packing_checks(dev)
    summary["checkpoint"], scene, cfg, state, mats, ckpt_launches = (
        checkpoint_checks(dev))
    log("phase 13: exec_paths against the launch counters")
    frames = dict(frames)
    frames["glTF (JPEG)"] = (jpeg_cfg, jpeg_lights, jpeg_launches,
                             JPEG_GLTF_FRAMES)
    frames["default, checkpoint frames"] = (cfg, scene.num_lights,
                                            ckpt_launches, CKPT_FRAMES)
    summary["exec_paths"] = {
        label: provenance_check(label, *args) for label, args in
        frames.items()}
    summary["profile"] = profiling_checks(scene, cfg, state, mats, phase5)
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"phase 13: {summary['seconds']:.1f} s")
    return summary



# -- phase 14: the interactive path --------------------------------------------

# R1's fp32 operations (csrc/overlay.cu; an fmaf counted as two, a compare
# as one): the three edge functions of a (pixel, triangle) pair (two
# differences, a product, an fmaf and the sign's product each) and their
# three compares; a pixel's clip test, blend (1 - a, three products, three
# products, three sums) and, for a textured mesh, its bilinear fetch
# (the texel position, four weights, 4 x 7 for the channels, 4 products).
R1_EDGE_OPS = 21
R1_BLEND_OPS = 10
R1_CLIP_OPS = 4
R1_TEX_OPS = 44
R1_SIZE = (1080, 1920)
R1_STRESS_TRIS = 2000
R1_HUD_FRAMES = 3
VIEWER_SIZE = (1920, 1080)
VIEWER_FRAMES = (6, 6)          # before and after the POST /input
WEB_SIZE = (640, 360)           # examples/web_viewer.py's default
WEB_FPS_WINDOW_S = 3.0
ENCODE_QUALITY = 85
PROGRESSIVE_JPEG = os.path.join("tests", "data", "progressive_96x64.jpg")
PROGRESSIVE_SHA256 = (
    "1c4458e1f301711493fa4722898932ae39c643d1cff790214bb17c552bd66458")


def r1_mesh(m, dev):
    """A mesh dict of tests/torch_overlay_cases.py as a Mesh2D on dev."""
    from sunray_tpu_torch.render import overlay2d

    return overlay2d.Mesh2D(
        xy=torch.from_numpy(m["xy"]).to(dev),
        uv=torch.from_numpy(m["uv"]).to(dev),
        rgba=torch.from_numpy(m["rgba"]).to(dev),
        tris=torch.from_numpy(m["tris"]).to(dev),
        tex=None if m["tex"] is None else torch.from_numpy(m["tex"]).to(dev),
        clip=m["clip"])


def r1_sets(dev):
    """R1's two timed inputs on the card: {label: (image, meshes)}: the
    1080p HUD of hud_overlay (4 lines at scale 2, a 120-sample plot) and
    the seeded stress set (tests/torch_overlay_cases.py)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_overlay_cases import (HUD_LINES, frame_times, seeded_image,
                                     stress_meshes)
    from sunray_tpu_torch.render import overlay2d

    h, w = R1_SIZE
    img = torch.from_numpy(seeded_image(h, w, 13)).to(dev)
    hud = [overlay2d.mesh_to(m, dev) for m in overlay2d.hud_meshes(
        HUD_LINES, frame_ms=frame_times(120, 14), scale=2.0)]
    stress = [r1_mesh(m, dev)
              for m in stress_meshes(h, w, R1_STRESS_TRIS, 11)]
    return {"hud": (img, hud), "stress": (img, stress)}


def r1_words_differ(got, want):
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def r1_adversarial(dev):
    """R1 against its plain twin, bit-equal, on every adversarial set of
    tests/torch_overlay_cases.py at 1080p. Returns {name: (meshes,
    triangles, words differing)}."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_overlay_cases import ADVERSARIAL, adversarial_set
    from sunray_tpu_torch.ops import cuda_overlay
    from sunray_tpu_torch.render.overlay2d import paint_meshes_plain

    out = {}
    for name in ADVERSARIAL:
        img, meshes = adversarial_set(name, *R1_SIZE, seed=21)
        img = torch.from_numpy(img).to(dev)
        meshes = [r1_mesh(m, dev) for m in meshes]
        diff = r1_words_differ(cuda_overlay.paint_meshes(img, meshes),
                               paint_meshes_plain(img, meshes))
        n_tris = sum(int(m.tris.shape[0]) for m in meshes)
        out[name] = (len(meshes), n_tris, diff)
        check(diff == 0, f"R1 {name}: {diff} words differ from the plain twin")
    log(f"phase 14: R1 bit-equal to plain on the adversarial sets at "
        f"{R1_SIZE[1]}x{R1_SIZE[0]} (meshes, triangles): "
        + ", ".join(f"{k} ({v[0]}, {v[1]})" for k, v in out.items()))
    return out


def wall_ms_a_call(fn, reps=20):
    """Host clock a call of fn(), its host work included: one warm-up,
    then `reps` calls and one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def r1_host_ms(dev):
    """wall_ms_a_call of hud_overlay (tessellation, packing, launch) and of
    paint_meshes on the HUD's meshes as hud_meshes builds them on the host
    (packing, copies, launch), on the 1080p image."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_overlay_cases import HUD_LINES, frame_times, seeded_image
    from sunray_tpu_torch.render import overlay2d

    img = torch.from_numpy(seeded_image(*R1_SIZE, 13)).to(dev)
    ms = frame_times(120, 14)
    meshes = overlay2d.hud_meshes(HUD_LINES, frame_ms=ms, scale=2.0)
    return {"hud_overlay": wall_ms_a_call(lambda: overlay2d.hud_overlay(
                img, HUD_LINES, frame_ms=ms, scale=2.0)),
            "paint_meshes": wall_ms_a_call(
                lambda: overlay2d.paint_meshes(img, meshes))}


def r1_needed_ops(meshes, h, w):
    """R1's operations on this input: the edge tests of every (pixel,
    triangle) pair whose pixel centre lies in the triangle's bounding box
    (degenerate triangles none), and each pixel's fetch, clip and blend
    for every mesh."""
    pairs = 0
    per_pixel = 0
    for m in meshes:
        v = m.xy[m.tris.long()].double().cpu().numpy()       # (T, 3, 2)
        area = ((v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
                - (v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1]))
        lo, hi = v.min(axis=1), v.max(axis=1)
        nx = (np.clip(np.floor(hi[:, 0] - 0.5), -1, w - 1)
              - np.clip(np.ceil(lo[:, 0] - 0.5), 0, w) + 1).clip(0)
        ny = (np.clip(np.floor(hi[:, 1] - 0.5), -1, h - 1)
              - np.clip(np.ceil(lo[:, 1] - 0.5), 0, h) + 1).clip(0)
        pairs += int((nx * ny)[np.abs(area) > 1e-8].sum())
        per_pixel += R1_BLEND_OPS + (R1_TEX_OPS if m.tex is not None else 0) \
            + (R1_CLIP_OPS if m.clip is not None else 0)
    return pairs * R1_EDGE_OPS + h * w * per_pixel


def r1_row(dev):
    """R1 against its plain twin on the card, bit-equal, on the HUD and the
    stress set; each timed beside its bound."""
    from sunray_tpu_torch.ops import cuda_overlay
    from sunray_tpu_torch.render.overlay2d import paint_meshes_plain

    row = {}
    for label, (img, meshes) in r1_sets(dev).items():
        h, w = img.shape[:2]
        packed = cuda_overlay.pack_meshes(meshes, h, w, dev)
        got = cuda_overlay.paint_meshes(img, meshes)
        want = paint_meshes_plain(img, meshes)
        diff = r1_words_differ(got, want)
        err = float((got - want).abs().max())
        n_tris = int(packed.tris.shape[0])
        check(diff == 0, f"R1 {label}: {diff} words differ from the plain "
              f"twin (max abs err {err})")
        again = r1_words_differ(cuda_overlay.paint_meshes(img, meshes), got)
        check(again == 0, f"R1 {label}: two runs differ in {again} words")
        ms = device_ms(lambda: cuda_overlay._launch_paint(img, packed))
        plain = time_ms(lambda: paint_meshes_plain(img, meshes),
                        reps=3 if label == "hud" else 1)   # stress: ~2.6 s
        ops = r1_needed_ops(meshes, h, w)
        b = bound(2 * nbytes(img) + nbytes(*packed), ops)
        log(f"phase 14: R1 {label}: {len(meshes)} meshes, {n_tris} triangles, "
            f"{w}x{h}; bit-equal to plain, two runs bit-equal; kernel "
            f"{ms:.4f} ms, plain "
            f"{plain:.3f} ms, bound {b[0]:.4f} ms ({b[1]}; {ops:.3e} ops)")
        entry = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound=b,
                     shape=f"{w}x{h}, {len(meshes)} meshes, {n_tris} tris")
        if label == "hud":
            row.update(entry, library_ms=None)
        else:
            row.update({f"stress_{k}": (v[0] if k == "bound" else v)
                        for k, v in entry.items()})
    return row


def r1_main_path(dev):
    """R1 on its path: hud_overlay on R1_HUD_FRAMES rendered 1080p Cornell
    frames, the counters zeroed just before and read just after."""
    from sunray_tpu_torch.camera import Camera
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.render.overlay2d import hud_overlay
    from sunray_tpu_torch.render.renderer import Renderer
    from sunray_tpu_torch.scene import cornell_box

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_overlay_cases import HUD_LINES, frame_times

    w, h = VIEWER_SIZE
    r = Renderer(RenderConfig(width=w, height=h), scene=cornell_box(device=dev),
                 device=dev)
    cam = Camera(**CAMERA)
    cuda_build.launches.clear()
    for i in range(R1_HUD_FRAMES):
        out = hud_overlay(r.render(cam), HUD_LINES,
                          frame_ms=frame_times(120, i), scale=2.0)
    torch.cuda.synchronize()
    launches = dict(cuda_build.launches)
    check(launches.get("paint_meshes", 0) == R1_HUD_FRAMES,
          f"hud_overlay: R1 launched {launches.get('paint_meshes', 0)} times "
          f"in {R1_HUD_FRAMES} frames")
    check(bool(torch.isfinite(out).all()), "hud_overlay: non-finite frame")
    log(f"phase 14: hud_overlay on {R1_HUD_FRAMES} rendered {w}x{h} frames: "
        f"launches {launches}")
    return launches


def http_request(port, path, method="GET", body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def encoder_checks(u8):
    """write_jpeg on a rendered 1080p frame (ms, median of 5), read back by
    utils/jpeg.read_jpeg (PSNR against the u8 frame); the committed
    progressive JPEG decoded, its pixels' SHA-256 against PIL's."""
    import hashlib

    from sunray_tpu_torch.utils.jpeg import read_jpeg, write_jpeg

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        data = write_jpeg(u8, ENCODE_QUALITY)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    back = read_jpeg(data)
    decode_s = time.perf_counter() - t0
    p = psnr(back / 255.0, u8 / 255.0)
    h, w = u8.shape[:2]
    log(f"phase 14: write_jpeg {w}x{h} q{ENCODE_QUALITY}: "
        f"{statistics.median(times):.2f} ms (median of 5), {len(data)} bytes; "
        f"read back in {decode_s:.2f} s, PSNR {p:.2f} dB against the u8 frame")
    check(back.shape == u8.shape, f"write_jpeg: decoded {back.shape}")
    check(p > 30.0, f"write_jpeg: PSNR {p:.2f} dB")
    t0 = time.perf_counter()
    px = read_jpeg(os.path.join(REPO, PROGRESSIVE_JPEG))
    prog_s = time.perf_counter() - t0
    digest = hashlib.sha256(px.tobytes()).hexdigest()
    log(f"phase 14: {PROGRESSIVE_JPEG} (progressive) {px.shape[1]}x"
        f"{px.shape[0]} decoded in {prog_s:.3f} s, SHA-256 {digest[:16]}...")
    check(digest == PROGRESSIVE_SHA256, "progressive JPEG: pixels differ from "
          "PIL's")
    return dict(encode_ms=statistics.median(times), bytes=len(data),
                psnr_db=p, decode_s=decode_s, progressive_decode_s=prog_s)


def live_viewer_check(dev):
    """LiveViewer at VIEWER_SIZE, Cornell ReSTIR, on 127.0.0.1 port 0: the
    frames before and after a POST /input; /frame.jpg decodes to the size,
    the camera moved, the frame's kernels launched (phase 5's counters,
    zeroed just before the run). Each stage of a frame is timed with a
    sync after it. Returns (summary, the last frame's u8)."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.integrations import viewer as viewer_mod
    from sunray_tpu_torch.integrations.engine import FlyCameraAdapter
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.render.renderer import Renderer
    from sunray_tpu_torch.scene import cornell_box
    from sunray_tpu_torch.utils.jpeg import read_jpeg

    w, h = VIEWER_SIZE
    r = Renderer(RenderConfig(width=w, height=h, lighting="restir"),
                 scene=cornell_box(device=dev), device=dev)
    stages = {}
    last = {}

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize(dev)
            stages.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
            last[key] = out
            return out
        return wrapper

    saved = {k: getattr(viewer_mod, k) for k in ("stats_overlay", "frame_u8",
                                                 "write_jpeg")}
    r.render = timed(r.render, "render")
    for k, key in (("stats_overlay", "overlay"), ("frame_u8", "u8_copy"),
                   ("write_jpeg", "encode")):
        setattr(viewer_mod, k, timed(saved[k], key))
    adapter = FlyCameraAdapter()
    v = viewer_mod.LiveViewer(r, adapter, host="127.0.0.1", port=0)
    port = int(v.address.rsplit(":", 1)[1])
    try:
        cuda_build.launches.clear()
        t0 = time.perf_counter()
        n = v.run(max_frames=VIEWER_FRAMES[0])
        pos0, yaw0 = adapter.flycam.position.copy(), adapter.flycam.yaw
        status, _ = http_request(port, "/input", "POST", json.dumps(
            {"keys": ["w", "d"], "dx": 40.0, "dy": -10.0}).encode())
        check(status == 200, f"LiveViewer: POST /input gave {status}")
        n += v.run(max_frames=VIEWER_FRAMES[1])
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.launches)
        status, jpg = http_request(port, "/frame.jpg")
        stats = json.loads(http_request(port, "/stats")[1])
    finally:
        v.stop()
        for k, fn in saved.items():
            setattr(viewer_mod, k, fn)
    check(status == 200, f"LiveViewer: GET /frame.jpg gave {status}")
    shape = read_jpeg(jpg).shape
    check(shape == (h, w, 3), f"LiveViewer: /frame.jpg decodes to {shape}")
    moved = float(np.abs(adapter.flycam.position - pos0).max())
    check(moved > 0 and adapter.flycam.yaw != yaw0,
          "LiveViewer: the camera did not move after POST /input")
    check(stats["frame"] == n, f"LiveViewer: /stats frame {stats['frame']}")
    for name in CORNELL_KERNELS:
        check(launches.get(name, 0) > 0, f"LiveViewer: kernel {name} never "
              "launched")
    med = {k: statistics.median(x) for k, x in stages.items()}
    fps = n / wall
    log(f"phase 14: LiveViewer {w}x{h} restir, {n} frames in {wall:.2f} s "
        f"({fps:.2f} frames/s, stages synced); camera moved {moved:.4f}; "
        f"/frame.jpg {len(jpg)} bytes; launches {launches}")
    log("  median ms a frame: " + ", ".join(f"{k} {med[k]:.2f}" for k in
                                             ("render", "overlay", "u8_copy",
                                              "encode")))
    log("  ms by frame: " + json.dumps(
        {k: [round(x, 2) for x in stages[k]] for k in stages}))
    return (dict(frames=n, fps=fps, stage_ms=med, jpeg_bytes=len(jpg),
                 camera_moved=moved), last["u8_copy"])


def stream_frame(port):
    """The latest frame of a ViewerServer's /stream, decoded to float."""
    import http.client

    from sunray_tpu_torch.utils.jpeg import read_jpeg

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/stream")
    resp = conn.getresponse()
    head = b""
    while not head.endswith(b"\r\n\r\n"):
        head += resp.read(1)
    n = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
    data = resp.read(n)
    conn.close()
    return read_jpeg(data).astype(np.float64) / 255.0


def spawn_window(server, w, h):
    """The pixel bounding box (x0, y0, x1, y1) of a ViewerServer's last
    spawned instance, projected through its fly-cam's camera."""
    from sunray_tpu_torch.camera import camera_matrices

    mesh = server.renderer._manager._meshes[server._spawn_key]
    t = server._spawned[-1].astype(np.float64)
    world = mesh.positions.astype(np.float64) @ t[:, :3].T + t[:, 3]
    vp = camera_matrices(server.adapter.flycam.camera(), w, h,
                         device="cpu")["view_proj"].double().numpy()
    clip = np.concatenate([world, np.ones((len(world), 1))], axis=1) @ vp.T
    px = (clip[:, :2] / clip[:, 3:4] + 1.0) / 2.0 * np.array([w, h])
    lo = np.clip(np.floor(px.min(axis=0)), 0, [w, h]).astype(int)
    hi = np.clip(np.ceil(px.max(axis=0)) + 1, 0, [w, h]).astype(int)
    return int(lo[0]), int(lo[1]), int(hi[0]), int(hi[1])


def window_change(a, b, win):
    """Mean over the window's pixels of the largest channel difference."""
    x0, y0, x1, y1 = win
    return float(np.abs(a[y0:y1, x0:x1] - b[y0:y1, x0:x1]).max(axis=-1)
                 .mean()) if x1 > x0 and y1 > y0 else 0.0


def web_viewer_check(dev):
    """ViewerServer at WEB_SIZE (Cornell ReSTIR, denoise_passes=2, the
    example's config) on the card: SPAWN through POST /input changes the
    instance count and the frame; PAUSE freezes the camera clock."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.integrations.web_viewer import ViewerServer

    w, h = WEB_SIZE
    cfg = RenderConfig(width=w, height=h, lighting="restir", denoise_passes=2)
    s = ViewerServer(cfg, port=0, device=dev)
    port = s.start()

    def state():
        return json.loads(http_request(port, "/state")[1])

    def wait(pred, frames=2, timeout=60.0):
        t0 = time.perf_counter()
        start = state()["frame"]
        while time.perf_counter() - t0 < timeout:
            st = state()
            if st["frame"] >= start + frames and pred(st):
                return st
            time.sleep(0.01)
        raise RuntimeError("chip_smoke: ViewerServer: timed out")

    def click(x):
        for kind in ("move", "down", "up"):
            http_request(port, "/input", "POST", json.dumps(
                {"type": kind, "x": x, "y": h - 13}).encode())

    try:
        st = wait(lambda st: True, frames=4)
        # Frames a second over a window in which this process only polls
        # /state: decoding the stream here (Python) would hold the
        # interpreter lock the server's render thread needs.
        t0, f0 = time.perf_counter(), st["frame"]
        time.sleep(WEB_FPS_WINDOW_S)
        st = state()
        fps = (st["frame"] - f0) / (time.perf_counter() - t0)
        a = stream_frame(port)
        wait(lambda st: True, frames=3)
        b = stream_frame(port)
        base = st["instances"]
        click(20)                                             # SPAWN
        st = wait(lambda st: st["spawned"] == 1, frames=3)
        c = stream_frame(port)
        check(st["instances"] == base + 1, f"ViewerServer: {st['instances']} "
              f"instances after SPAWN, {base} before")
        win = spawn_window(s, w, h)
        share, noise = window_change(b, c, win), window_change(a, b, win)
        check(share > max(0.02, 3 * noise),
              f"ViewerServer: SPAWN changed its window {win} by {share:.4f} "
              f"on average (two frames without it: {noise:.4f})")
        click(120)                                            # PAUSE
        st = wait(lambda st: st["paused"])
        cam = st["camera"]
        http_request(port, "/input", "POST", json.dumps(
            {"type": "keys", "keys": ["w"], "dx": 20.0, "dy": 0.0}).encode())
        st = wait(lambda st: True, frames=3)
        check(st["camera"] == cam, "ViewerServer: the camera moved while "
              "paused")
    finally:
        s.stop()
        s._render_thread.join(timeout=60)
    log(f"phase 14: ViewerServer {w}x{h}: SPAWN -> {st['instances']} "
        f"instances, its window {win} changed by {share:.4f} ({noise:.4f} "
        f"without it); PAUSE held the camera; {fps:.2f} frames/s (server's own "
        f"estimate {st['fps']})")
    return dict(fps=fps, spawn_changed=share, noise_changed=noise)


def phase_viewers(dev):
    """Phase 14. Returns (summary, R1's row, R1's launches on its path)."""
    t_phase = time.perf_counter()
    summary = {}
    row = r1_row(dev)
    summary["r1_adversarial"] = r1_adversarial(dev)
    host = r1_host_ms(dev)
    summary["r1_wall_ms_a_call"] = dict(host, device=row["ms"])
    log(f"phase 14: wall a call on the 1080p HUD: hud_overlay "
        f"{host['hud_overlay']:.4f} ms, paint_meshes {host['paint_meshes']:.4f} "
        f"ms (host packing, copies and launch), against R1's {row['ms']:.4f} "
        "ms on the card")
    launches = r1_main_path(dev)
    summary["live_viewer"], u8 = live_viewer_check(dev)
    summary["encoder"] = encoder_checks(u8)
    summary["web_viewer"] = web_viewer_check(dev)
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14: {summary['seconds']:.1f} s")
    return summary, row, launches


# -- phase 15: multi-device rendering (parallel/) -----------------------------

PAR_SIZE = (1920, 1080)
PAR_RANKS = 4                       # gloo processes sharing the one card
PAR_FRAMES = 3                      # frames a camera path, (a) and (b)
PAR_TRAIN_SIZE = (320, 180)         # (c), at (dp, sp) = (2, 2)
# (c)'s configs: the default ReSTIR config (TAA on, 4 a-trous passes, DI
# 30, GI 20) and the JAX dryrun's NEE config (TAA off, no denoise).
PAR_TRAIN_KW = {"restir": dict(differentiable=True),
                "nee": dict(lighting="nee", bounces=2, virtual_bounces=2,
                            denoise_passes=0, enable_taa=False,
                            differentiable=True)}
PAR_RTOL = 1e-5                     # (c): loss, and gradient of the largest
PAR_TIMEOUT_S = 300                 # the ranks' join and gloo timeout
# (b)'s frame: the default 1080p ReSTIR config (DI 30, GI 20, 4 a-trous
# passes, halo_t 16) with the history reads through K13, so that K13 runs
# on the halo-extended table, and TAA through K9's window form.
PAR_KW = dict(history_select_kernel="auto", taa_kernel="auto")
# The kernels every rank must launch in (b) and those that must not run in
# their whole-frame form there.
PAR_RANK_KERNELS = ("trace_closest", "trace_occluded", "gather_rows",
                    "gather_rows_multi", "ris_audition", "di_temporal",
                    "di_spatial_window", "gi_spatial", "atrous_pass_window",
                    "history_gather", "taa_clamp_blend_window")
PAR_ABSENT = ("di_spatial", "atrous_pass", "taa_clamp_blend")
# (b)'s fast camera (tests/torch_dist.cameras("fast")): it moves far
# beyond halo_t between frames, rendered by render_frame_sharded, whose
# history halo reaches the whole image.
PAR_FAST_STEP = 0.6


def par_cameras(kind):
    """tests/test_spmd.py's static camera, slow orbit and fast motion."""
    from sunray_tpu_torch.camera import Camera

    if kind == "static":
        return [Camera(**CAMERA)] * PAR_FRAMES
    if kind == "fast":
        return [Camera(position=(1.0, 1.0 + PAR_FAST_STEP * i, 3.4),
                       target=(1.0, 1.0, 0.0), fov_y=45.0)
                for i in range(PAR_FRAMES)]
    return [Camera(position=(1.0 + 0.02 * i, 1.0, 3.4 - 0.02 * i),
                   target=(1.0, 1.0, 0.0), fov_y=45.0)
            for i in range(PAR_FRAMES)]


def par_train_case(dev):
    """(c)'s views (two, the dryrun's cameras) and seeded targets."""
    from sunray_tpu_torch.camera import Camera, camera_matrices

    w, h = PAR_TRAIN_SIZE
    per = [camera_matrices(Camera(position=(1.0, 1.0, 3.2 + 0.1 * i),
                                  target=(1.0, 1.0, 0.0), fov_y=45.0),
                           w, h, device=dev) for i in range(2)]
    mats = {k: torch.stack([m[k] for m in per]) for k in per[0]}
    gen = torch.Generator().manual_seed(15)
    targets = torch.rand((2, h, w, 3), generator=gen).to(dev)
    return mats, targets


def par_train(dev, mesh, name):
    """training_step of (c)'s config `name` on `mesh`: (loss, gradient on
    the host, ms, this rank's traffic tally)."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.halo import traffic_tally
    from sunray_tpu_torch.parallel.sharding import training_step
    from sunray_tpu_torch.scene import cornell_box

    w, h = PAR_TRAIN_SIZE
    cfg = RenderConfig(width=w, height=h, **PAR_TRAIN_KW[name])
    mats, targets = par_train_case(dev)
    scene = cornell_box(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with traffic_tally() as t:
        loss, grad = training_step(scene, cfg, mats, targets, mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return float(loss), grad.cpu(), ms, dict(t)


def _timed_exchanges(record):
    """Wrap halo.exchange_rows (and postprocess's import of it) so that
    each call's wall time, the card synchronised before and after, adds
    to record["ms"]; returns the undo."""
    from sunray_tpu_torch.parallel import halo
    from sunray_tpu_torch.render import postprocess

    saved = halo.exchange_rows

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = saved(*args, **kwargs)
        torch.cuda.synchronize()
        record["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    halo.exchange_rows = postprocess.exchange_rows = timed

    def undo():
        halo.exchange_rows = postprocess.exchange_rows = saved
    return undo


def par_rank(rank, world, tmp):
    """One gloo rank of phase 15 (b) and (c) on the card: the 1080p frame's
    band for the static and slow paths (launches, tally, exchange and
    frame ms; rank 0 also renders the single-device frames and compares),
    render_frame_sharded on the (1, 4) mesh under fast motion (tally,
    frame ms; rank 0 compares), then training_step on the (2, 2) mesh,
    each config of (c). Returns its measurements."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from sunray_tpu_torch.camera import camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.parallel.halo import traffic_tally
    from sunray_tpu_torch.parallel.sharding import (
        make_mesh,
        render_frame_sharded,
    )
    from sunray_tpu_torch.parallel.spmd import (
        gather_rows,
        make_spmd_step,
        shard_state,
    )
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"file://{tmp}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    cuda_build.library()
    w, h = PAR_SIZE
    cfg = RenderConfig(width=w, height=h, **PAR_KW)
    scene = cornell_box(device=dev)
    out = {"rank": rank, "paths": {}}
    images = {}
    for kind in ("static", "slow"):
        step = make_spmd_step(scene, cfg)
        state = shard_state(RenderState.create(cfg, dev), cfg, step.grid)
        record = {"ms": 0.0}
        undo = _timed_exchanges(record)
        cuda_build.launches.clear()
        frame_ms, tallies, imgs = [], [], []
        try:
            for cam in par_cameras(kind):
                mats = camera_matrices(cam, w, h, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with traffic_tally() as t:
                    state, ldr, _ = step(state, mats)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                tallies.append(dict(t))
                imgs.append(gather_rows(ldr))
        finally:
            undo()
        out["paths"][kind] = dict(
            launches=dict(cuda_build.launches), frame_ms=frame_ms,
            exchange_ms_a_frame=record["ms"] / PAR_FRAMES,
            bytes_a_frame=tallies[0]["bytes"],
            sent_bytes_a_frame=tallies[0]["sent_bytes"],
            tallies_equal=all(t == tallies[0] for t in tallies))
        images[kind] = imgs
    # render_frame_sharded: each band a share of the single-device frame,
    # the history halo the whole image (halo_t = H - hl).
    mesh = make_mesh(world, dp=1)
    state = RenderState.create(cfg, dev)
    frame_ms, tallies, imgs = [], [], []
    for cam in par_cameras("fast"):
        mats = camera_matrices(cam, w, h, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with traffic_tally() as t:
            state, ldr, _ = render_frame_sharded(scene, cfg, state, mats,
                                                 mesh)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        tallies.append(dict(t))
        imgs.append(ldr)
    out["paths"]["fast"] = dict(
        frame_ms=frame_ms, bytes_a_frame=tallies[0]["bytes"],
        sent_bytes_a_frame=tallies[0]["sent_bytes"],
        tallies_equal=all(t == tallies[0] for t in tallies))
    images["fast"] = imgs
    dist.barrier()
    if rank == 0:
        # The single-device frames on the card, rendered after every
        # rank's timed frames.
        for kind, bars in (("static", 2e-5), ("slow", 2e-4), ("fast", 2e-4)):
            state = RenderState.create(cfg, dev)
            match, finite = [], True
            for cam, got in zip(par_cameras(kind), images[kind]):
                mats = camera_matrices(cam, w, h, device=dev)
                state, ref, _ = render_frame(scene, cfg, state, mats)
                ok = torch.isclose(got, ref, rtol=bars, atol=bars).all(dim=-1)
                match.append(ok.float().mean().item())
                finite = finite and bool(torch.isfinite(got).all())
            out["paths"][kind].update(match=match, finite=finite, bar=bars)
    dist.barrier()
    mesh = make_mesh(world, dp=2)
    out["train"] = {name: par_train(dev, mesh, name) for name in PAR_TRAIN_KW}
    out["mesh"] = (mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index)
    dist.destroy_process_group()
    return out


def _par_child(rank, world, tmp):
    res = par_rank(rank, world, tmp)
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))


def par_spawn(world):
    """par_rank on `world` spawned processes; their results. A child's
    failure fails the phase (join re-raises), and so does a join that
    outlasts PAR_TIMEOUT_S (the children are then terminated)."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_par_child, args=(world, tmp), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.perf_counter() + PAR_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                raise RuntimeError(f"chip_smoke: phase 15 ranks still running "
                                   f"after {PAR_TIMEOUT_S} s")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def par_world_one(dev, phase5_ms):
    """(a): NCCL at world size 1 (a FileStore in a temporary directory):
    the row-sharded frame on phase 5's 1080p Cornell ReSTIR frame for
    PAR_FRAMES frames, bit-equal to render_frame from the same state, and
    phase 5's kernels launched (K5 and K7 in their window form)."""
    import tempfile

    import torch.distributed as dist

    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.ops import cuda_build
    from sunray_tpu_torch.parallel.spmd import make_spmd_step, shard_state
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    w, h = PAR_SIZE
    cfg = RenderConfig(width=w, height=h, lighting="restir")
    scene = cornell_box(device=dev)
    mats = camera_matrices(Camera(**CAMERA), w, h, device=dev)
    refs, state = [], RenderState.create(cfg, dev)
    for _ in range(PAR_FRAMES):
        state, ldr, _ = render_frame(scene, cfg, state, mats)
        refs.append(ldr)
    ref_state = state
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            check(dist.get_backend() == "nccl", "phase 15 (a): not NCCL")
            step = make_spmd_step(scene, cfg)
            state = shard_state(RenderState.create(cfg, dev), cfg, step.grid)
            cuda_build.launches.clear()
            frame_ms, equal = [], []
            for ref in refs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, ldr, _ = step(state, mats)
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                equal.append(torch.equal(ldr.view(torch.int32),
                                         ref.view(torch.int32)))
            launches = dict(cuda_build.launches)
        finally:
            dist.destroy_process_group()
    accum_equal = torch.equal(state.accum.view(torch.int32),
                              ref_state.accum.view(torch.int32))
    log(f"  (a) NCCL world 1, {w}x{h} ReSTIR, {PAR_FRAMES} frames: ldr "
        f"bit-equal to render_frame {equal}, TAA history bit-equal "
        f"{accum_equal}; frame ms {[round(t, 3) for t in frame_ms]} (phase 5: "
        f"{phase5_ms:.3f} ms a frame, mean of 20)")
    log(f"  (a) launches: {launches}")
    check(all(equal) and accum_equal, "phase 15 (a): not bit-equal")
    want = [{"di_spatial": "di_spatial_window",
             "atrous_pass": "atrous_pass_window"}.get(k, k)
            for k in CORNELL_KERNELS]
    for name in want:
        check(launches.get(name, 0) > 0, f"phase 15 (a): {name} never launched")
    for name in ("di_spatial", "atrous_pass"):
        check(launches.get(name, 0) == 0,
              f"phase 15 (a): {name} launched in its whole-frame form")
    return dict(bit_equal=all(equal) and accum_equal, frame_ms=frame_ms,
                phase5_frame_ms=phase5_ms, launches=launches)


def par_windows(dev):
    """(d): K5, K7 and K9 in window form and K6 on a band, on the 1080p/4
    band of rows 270-539 (rank 1 of 4) of frame 2's inputs (K9: frame 3's,
    the first whose TAA reads history), against their plain twins (K5 and
    K6 by the take-flip scheme, K7 within ATROUS_ATOL, K9 bit-equal) and
    timed as phase 3 times them. Returns the three rows and K6's."""
    from sunray_tpu_torch.ops import cuda_image, cuda_restir

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_window_cases import atrous_window, window

    def band_window(x, halo):
        return window(x, h, row0, hl, halo).contiguous()

    w, h = PAR_SIZE
    hl = h // PAR_RANKS
    row0 = hl
    lanes = slice(row0 * w, (row0 + hl) * w)
    calls = capture_calls(dev, {"di_spatial": "cuda_restir",
                                "gi_spatial": "cuda_restir"}, 2)
    rows = {}

    # K5: the centre reservoir and guides as a halo_s window.
    whole = calls["di_spatial"][0][0]
    (table, seeds, center, taps, pending, gnormal, gdepth, cur, pos, normal,
     view, albedo, rough, metal, _, _, clamps) = whole
    halo = 31                       # max(DI 30, GI 20) + 1
    band = (table, seeds[lanes],
            {k: band_window(v, halo) for k, v in center.items()},
            taps, pending[lanes], band_window(gnormal, halo),
            band_window(gdepth, halo), cur[lanes], pos[lanes],
            normal[lanes], view[lanes], albedo[lanes], rough[lanes],
            metal[lanes], w, hl, clamps)
    win = dict(row0=row0, halo=halo, h_global=h)
    agree, err = compare_restir("di_spatial", band, "1080p/4 window", win)
    k_band = cuda_restir.di_spatial(*band, **win)
    k_whole = cuda_restir.di_spatial(*whole)
    torch.cuda.synchronize()
    same = torch.equal(k_band[0], k_whole[0][lanes]) and all(
        torch.equal(k_band[1][k], k_whole[1][k][lanes]) for k in k_band[1])
    log(f"  K5 window: taps {taps}; bit-equal to the whole frame's K5 on "
        f"the band's lanes {same}")
    check(same, "phase 15 (d): K5's window form differs from the whole frame")
    r = dict(agree=agree, max_abs_err=err, whole_frame_bit_equal=same,
             shape=[hl, w, halo])
    r["bound"] = bound(nbytes(*flatten(band)) + nbytes(*flatten(k_band)),
                       hl * w * restir_lane_ops("di_spatial", band))
    r["ms"] = device_ms(lambda: cuda_restir.di_spatial(*band, **win))
    r["plain_ms"] = time_ms(lambda: cuda_restir.di_spatial_plain(*band, **win))
    rows["di_spatial_window"] = r

    # K6: the band's lanes of its (T, P) tap planes (cut from the window
    # in the sharded frame).
    g = calls["gi_spatial"][0][0]
    gband = (g[0][lanes], {k: v[lanes] for k, v in g[1].items()},
             {k: v[:, lanes].contiguous() for k, v in g[2].items()},
             *(x[lanes] for x in g[3:8]), *g[8:])
    agree, err = compare_restir("gi_spatial", gband, "1080p/4 band")
    out = cuda_restir.gi_spatial(*gband)
    r = dict(agree=agree, max_abs_err=err,
             bound=bound(nbytes(*flatten(gband)) + nbytes(*flatten(out)),
                         hl * w * restir_lane_ops("gi_spatial", gband)),
             ms=device_ms(lambda: cuda_restir.gi_spatial(*gband)),
             plain_ms=time_ms(lambda: cuda_restir.gi_spatial_plain(*gband)))
    rows["gi_spatial_band"] = r

    # K7: each pass's window (2 * step rows above and below).
    guides = capture_denoise_inputs(dev)
    err, ms, plain_ms, n_b, n_ops = 0.0, 0.0, 0.0, 0, 0
    for i in range(4):
        s = 1 << i
        hp = 2 * s
        wg, kw = atrous_window(guides, row0, hl, hp)
        k = cuda_image.atrous_pass(*wg, s, **kw)
        p = cuda_image.atrous_denoise_pass(*wg, s, **kw)
        whole_k = cuda_image.atrous_pass(*guides, s)
        torch.cuda.synchronize()
        e = (k - p).abs().max().item()
        band_equal = torch.equal(k[hp:hp + hl], whole_k[row0:row0 + hl])
        log(f"  K7 window step {s}: {wg[0].shape[0]} rows, max abs err vs "
            f"plain {e:.3g}, band rows bit-equal to the whole-image pass "
            f"{band_equal}")
        check(e <= ATROUS_ATOL, f"phase 15 (d): K7 window step {s} error {e}")
        check(band_equal, f"phase 15 (d): K7 window step {s} differs from the "
              "whole image's pass")
        err = max(err, e)
        ms += device_ms(lambda: cuda_image.atrous_pass(*wg, s, **kw))
        plain_ms += time_ms(lambda: cuda_image.atrous_denoise_pass(*wg, s,
                                                                   **kw))
        n_b += nbytes(*wg) + nbytes(wg[0])
        n_ops += round(wg[0].shape[0] * w * (1.0 - bypass_share(wg))) \
            * 24 * ATROUS_TAP_OPS
    rows["atrous_pass_window"] = dict(
        max_abs_err=err, ms=ms / 4, plain_ms=plain_ms / 4,
        bound=bound(n_b / 4, n_ops / 4), shape=[hl, w])

    # K9's window form: the band's raw with the rows above and below it,
    # its history and mask, of frame 3 (the first whose TAA reads history:
    # use_history needs frame_count > 2) of the 1080p ReSTIR frame.
    (taa_args, _), = capture_calls(dev, {"taa_clamp_blend": "cuda_image"}, 3,
                                   taa_kernel="auto")["taa_clamp_blend"]
    raw, hist, use, factor = taa_args
    band = slice(row0, row0 + hl)
    wargs = (raw[band], hist[band].contiguous(), use[band].contiguous(),
             factor)
    raw_x = raw[row0 - 1:row0 + hl + 1].contiguous()
    k = cuda_image.taa_clamp_blend(*wargs, raw_x=raw_x)
    p = cuda_image.taa_clamp_blend_plain(*wargs, raw_x=raw_x)
    whole = cuda_image.taa_clamp_blend(*taa_args)
    torch.cuda.synchronize()
    exact = torch.equal(k.view(torch.int32), p.view(torch.int32))
    band_equal = torch.equal(k.view(torch.int32), whole[band].view(torch.int32))
    share = wargs[2].float().mean().item()
    log(f"  K9 window: {tuple(raw_x.shape)} window, use share {share:.4f}, "
        f"bit-equal to its plain twin {exact}, to the whole frame's K9 on the "
        f"band {band_equal}")
    check(exact, "phase 15 (d): K9's window form differs from its plain twin")
    check(band_equal, "phase 15 (d): K9's window form differs from the "
          "whole frame's K9")
    check(share > 0.5, f"phase 15 (d): K9 history used on only {share}")
    rows["taa_clamp_blend_window"] = dict(
        max_abs_err=(k - p).abs().max().item(), whole_frame_bit_equal=band_equal,
        ms=device_ms(lambda: cuda_image.taa_clamp_blend(*wargs, raw_x=raw_x)),
        plain_ms=time_ms(lambda: cuda_image.taa_clamp_blend_plain(
            *wargs, raw_x=raw_x)),
        # the window, history and mask read once, the band written once;
        # phase 3's ~120 fp32 operations a pixel
        bound=bound(nbytes(raw_x, *wargs[1:3]) + nbytes(k), hl * w * 120),
        shape=[hl, w])
    for name, r in rows.items():
        log(f"  (d) {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]})")
    return rows


def phase_parallel(dev, phase5_ms):
    """Phase 15: multi-device rendering (parallel/) on the one card: (a)
    NCCL at world size 1, bit-equal to render_frame; (b) PAR_RANKS gloo
    ranks sharing the card on the 1080p frame (static and slow orbit) held
    to the single-device frame at tests/test_spmd.py's bars, every rank's
    kernels and halo traffic; (c) training_step at (dp, sp) = (2, 2)
    against the single-device step; (d) the window kernels against their
    plain twins. The exchange times are of host-staged gloo messages
    between processes that share one card: not a scaling figure. Returns
    (summary, kernel rows, launches of (b)'s rank 0)."""
    from sunray_tpu_torch.parallel.sharding import make_mesh

    t_phase = time.perf_counter()
    w, h = PAR_SIZE
    log(f"phase 15: multi-device rendering, {w}x{h}")
    summary = {"world_one": par_world_one(dev, phase5_ms)}

    mesh1 = make_mesh()
    check(mesh1.shape == (1, 1), f"phase 15: world-1 mesh {mesh1.shape}")
    refs = {name: par_train(dev, mesh1, name) for name in PAR_TRAIN_KW}
    t0 = time.perf_counter()
    ranks = par_spawn(PAR_RANKS)
    spawn_s = time.perf_counter() - t0
    per_rank = []
    for r in ranks:
        for kind, p in r["paths"].items():
            check(p["tallies_equal"], f"phase 15 (b) rank {r['rank']}: "
                  f"{kind} tallies differ between frames")
            if kind == "fast":
                continue
            for name in PAR_RANK_KERNELS:
                check(p["launches"].get(name, 0) > 0,
                      f"phase 15 (b) rank {r['rank']} {kind}: {name} never "
                      "launched")
            for name in PAR_ABSENT:
                check(p["launches"].get(name, 0) == 0,
                      f"phase 15 (b) rank {r['rank']} {kind}: {name} launched")
        per_rank.append({kind: {k: p[k] for k in (
            "frame_ms", "exchange_ms_a_frame", "bytes_a_frame",
            "sent_bytes_a_frame") if k in p}
            for kind, p in r["paths"].items()})
        log(f"  (b) rank {r['rank']}: " + "; ".join(
            f"{kind} frame ms {[round(t, 2) for t in p['frame_ms']]}, "
            + (f"host-staged exchanges {p['exchange_ms_a_frame']:.2f} ms a "
               "frame, " if "exchange_ms_a_frame" in p else
               "render_frame_sharded (1, 4), ")
            + f"{p['bytes_a_frame']} bytes a frame (sent "
            f"{p['sent_bytes_a_frame']})" for kind, p in r["paths"].items()))
    for kind, p in ranks[0]["paths"].items():
        log(f"  (b) {kind}: pixels within {p['bar']:g} of the single-device "
            f"frame {p['match']}, finite {p['finite']}")
        check(p["finite"], f"phase 15 (b) {kind}: non-finite pixels")
        check(min(p["match"]) >= 0.995,
              f"phase 15 (b) {kind}: only {min(p['match'])} of pixels match")
    summary["ranks"] = dict(
        n=PAR_RANKS, spawn_s=spawn_s, per_rank=per_rank,
        match={k: p["match"] for k, p in ranks[0]["paths"].items()},
        launches_rank0=ranks[0]["paths"]["slow"]["launches"],
        note="4 processes share one card over gloo, halos staged through "
             "the host: not a scaling figure")

    summary["train"] = {}
    for name, (ref_loss, ref_grad, ref_ms, _) in refs.items():
        scale = ref_grad.abs().max().item()
        train = []
        for r in ranks:
            loss, grad, ms, tally = r["train"][name]
            gerr = (grad - ref_grad).abs().max().item()
            train.append(dict(mesh=r["mesh"], loss=loss, grad_err=gerr,
                              ms=ms, bytes=tally["bytes"],
                              grad_bytes=tally["grad_bytes"],
                              grad_calls=tally["grad_calls"]))
            check(abs(loss - ref_loss) <= PAR_RTOL * abs(ref_loss),
                  f"phase 15 (c) {name} rank {r['rank']}: loss {loss} vs "
                  f"{ref_loss}")
            check(gerr <= PAR_RTOL * scale,
                  f"phase 15 (c) {name} rank {r['rank']}: gradient off by "
                  f"{gerr} (largest {scale})")
        log(f"  (c) training_step {name} (2, 2) at {PAR_TRAIN_SIZE}: "
            f"single-device loss {ref_loss:.7g}, {ref_ms:.1f} ms; ranks "
            + "; ".join(f"{t['mesh']} loss {t['loss']:.7g} grad err "
                        f"{t['grad_err']:.3g} {t['ms']:.1f} ms, {t['bytes']} "
                        f"bytes, backward {t['grad_bytes']} bytes in "
                        f"{t['grad_calls']} hops" for t in train))
        summary["train"][name] = dict(size=list(PAR_TRAIN_SIZE),
                                      ref_loss=ref_loss, ref_ms=ref_ms,
                                      grad_scale=scale, ranks=train)

    rows = par_windows(dev)
    summary["windows"] = {k: {kk: vv for kk, vv in v.items()}
                          for k, v in rows.items()}
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 15 took {summary['phase_s']:.1f} s")
    launches = dict(ranks[0]["paths"]["slow"]["launches"])
    return summary, rows, launches


# -- phase 16: the example programs --------------------------------------------

# Each examples/torch_*.py program's run(...) in-process on the card, its
# stdout redirected (the script's last line is the contract's). Every
# program runs at its defaults, except two depths cut to fit the script's
# limit (PERF.md section 4): optimize_camera --joint --edge-aa runs
# EX_JOINT_STEPS of its 80 steps and the orbit over phase 10's glTF
# EX_GLTF_ORBIT_FRAMES of its 72 frames.
EX_JOINT_STEPS = 20
EX_GLTF_ORBIT_FRAMES = 12
EX_TERM_FRAMES = 30
EX_ALBEDO_ERR = 0.05            # the material loop's final max albedo error
EX_CARD_CPU_SIZE, EX_CARD_CPU_STEPS = (24, 18), 2
# The forward ReSTIR frame's kernels on the Cornell box and the reflection
# room (brute force); on phase 10's glTF the two-level walk (B3) takes
# every trace query in place of K1 and K2.
EX_GLTF_KERNELS = ("bvh2_walk", "gather_rows", "gather_rows_multi",
                   "ris_audition", "di_temporal", "di_spatial", "gi_spatial",
                   "atrous_pass")
# The differentiable loops: the tracer and K8 forward; K8's backward where
# the material table requires grad; K3-K7's plain versions (JAX's gates,
# DIFF_ABSENT) and, for the pose, no table gradient at all.
EX_POSE_KERNELS = ("trace_closest", "trace_occluded", "gather_rows",
                   "gather_rows_multi")
EX_KERNELS = {
    "render_png cornell": CORNELL_KERNELS,
    "render_png room": CORNELL_KERNELS,
    "optimize_material": DIFF_KERNELS,
    "optimize_camera": EX_POSE_KERNELS,
    "optimize_camera joint edge-aa": EX_POSE_KERNELS,
    "orbit cornell": CORNELL_KERNELS,
    "orbit gltf": EX_GLTF_KERNELS,
    "term_viewer": CORNELL_KERNELS,
    # the aux frame of parity_report.py:303-305 passes no load-time accel:
    # an LBVH built in the frame, walked by B2
    "parity_report": EX_GLTF_KERNELS + ("bvh_walk",),
}
EX_ABSENT = {"optimize_material": DIFF_ABSENT,
             "optimize_camera": DIFF_ABSENT + ("gather_rows_bwd",),
             "optimize_camera joint edge-aa": DIFF_ABSENT
             + ("gather_rows_bwd",)}
# Each kernel's plain twin, at the name its wrapper calls it by: a call on
# card tensors is a path that skipped its kernel. The differentiable
# loops run K7's plain passes on the card (JAX's gate), so they are held
# to the tracer's and K8's twins only.
EX_TWINS = (("ops.intersect", "trace_closest_brute"),
            ("ops.intersect", "trace_occluded_brute"),
            ("ops.intersect", "trace_occluded_woop"),
            ("ops.cuda_gather", "gather_rows_plain"),
            ("ops.cuda_gather", "gather_rows_bwd_plain"),
            ("ops.cuda_image", "atrous_denoise_pass"),
            ("ops.cuda_image", "atrous_denoise_plain"),
            ("ops.cuda_image", "taa_clamp_blend_plain"),
            ("ops.cuda_restir", "ris_audition_plain"),
            ("ops.cuda_restir", "di_temporal_plain"),
            ("ops.cuda_restir", "di_spatial_plain"),
            ("ops.cuda_restir", "gi_spatial_plain"),
            ("ops.cuda_history", "history_gather_plain"),
            ("ops.cuda_bvh", "walk_plain"),
            ("ops.cuda_bvh", "walk_alpha_plain"))
EX_DIFF_TWINS = ("trace_closest_brute", "trace_occluded_brute",
                 "gather_rows_plain", "gather_rows_bwd_plain")
# The default config's own plain stages, as JAX's defaults: TAA's clamp
# and blend (taa_kernel="jnp") and the history reads
# (history_select_kernel="off"); K9 and K13 run only when switched on.
EX_CONFIG_TWINS = ("taa_clamp_blend_plain", "history_gather_plain")


class TwinSpy:
    """While entered, counts the calls of each EX_TWINS function that get
    a tensor on the card (the wrappers take their plain twin only for CPU
    tensors, and the frame's gates for JAX's plain stages)."""

    def __enter__(self):
        import collections
        import importlib

        # Modules that bind a twin under their own name at import (e.g.
        # render/postprocess.taa_clamp_blend) keep the function itself.
        importlib.import_module("sunray_tpu_torch.render.renderer")
        self.calls = collections.Counter()
        self.saved = []
        for mod_name, attr in EX_TWINS:
            mod = importlib.import_module("sunray_tpu_torch." + mod_name)
            fn = getattr(mod, attr)

            def spy(*args, _fn=fn, _name=attr, **kw):
                if any(torch.is_tensor(x) and x.is_cuda
                       for x in (*args, *kw.values())):
                    self.calls[_name] += 1
                return _fn(*args, **kw)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, spy)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def example_run(name, fn, spy, **kw):
    """fn(**kw) with stdout captured and the launch counters zeroed before
    and read after; checks the program's kernels (EX_KERNELS) launched,
    EX_ABSENT's did not, and no plain twin ran on the card (the loops:
    EX_DIFF_TWINS). Returns (fn's result, its stdout, summary)."""
    import contextlib
    import io

    from sunray_tpu_torch.ops import cuda_build

    torch.cuda.synchronize()
    cuda_build.launches.clear()
    spy.calls.clear()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn(**kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda_build.launches)
    twins = dict(spy.calls)
    for k in EX_KERNELS[name]:
        check(launches.get(k, 0) > 0, f"phase 16 {name}: {k} never launched")
    for k in EX_ABSENT.get(name, ()):
        check(launches.get(k, 0) == 0, f"phase 16 {name}: {k} launched")
    held = (EX_DIFF_TWINS if name in EX_ABSENT else
            [a for _, a in EX_TWINS if a not in EX_CONFIG_TWINS])
    bad = {k: v for k, v in twins.items() if k in held}
    check(not bad, f"phase 16 {name}: plain twins on the card {bad}")
    return result, out.getvalue(), dict(seconds=seconds, launches=launches,
                                        card_twin_calls=twins)


def material_steps(device):
    """[(loss, [gradient])] of the first EX_CARD_CPU_STEPS steps of
    torch_optimize_material's loop at EX_CARD_CPU_SIZE."""
    from examples import torch_optimize_material as ex

    pb = ex.problem(EX_CARD_CPU_SIZE, device=device)
    p = pb.init.clone().requires_grad_()
    opt = ex.optimizer(p, 0.6 * 0.05)
    steps = []
    for _ in range(EX_CARD_CPU_STEPS):
        loss = pb.loss(p)
        g, = torch.autograd.grad(loss, p)
        steps.append((float(loss.detach()), [g.cpu()]))
        ex.apply_step(opt, p, g)
    return steps


def pose_steps(device, **kw):
    """The same for torch_optimize_camera's loop (kw: edge_aa, joint)."""
    from examples import torch_optimize_camera as ex

    pb = ex.problem(EX_CARD_CPU_SIZE, device=device, **kw)
    params = {k: v.clone().requires_grad_() for k, v in pb.init.items()}
    opt = ex.optimizer(params, 2e-2)
    steps = []
    for _ in range(EX_CARD_CPU_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = pb.loss(params)
        loss.backward()
        steps.append((float(loss.detach()),
                      [p.grad.cpu() for p in params.values()]))
        opt.step()
    return steps


def example_card_vs_cpu(dev, name, steps_fn, **kw):
    """steps_fn on the card and on the CPU port: losses within
    DIFF_LOSS_RTOL, gradients within phase 8's bars (grads_close)."""
    card, cpu = steps_fn(dev, **kw), steps_fn(torch.device("cpu"), **kw)
    out = []
    for i, ((lg, gg), (lc, gc)) in enumerate(zip(card, cpu)):
        rel = abs(lg - lc) / abs(lc)
        errs = [grads_close(a, b) for a, b in zip(gg, gc)]
        check(rel <= DIFF_LOSS_RTOL, f"phase 16 {name} step {i}: card vs CPU "
              f"loss rel {rel}")
        check(all(ok for ok, _ in errs), f"phase 16 {name} step {i}: "
              f"gradient card vs CPU {[e for _, e in errs]}")
        out.append(dict(loss_card=lg, loss_cpu=lc, loss_rel=rel,
                        grad_err=[e for _, e in errs]))
    log(f"  {name} card vs CPU at {EX_CARD_CPU_SIZE[0]}x{EX_CARD_CPU_SIZE[1]}"
        f", {EX_CARD_CPU_STEPS} steps: " + "; ".join(
            f"loss {s['loss_card']:.7g} / {s['loss_cpu']:.7g} (rel "
            f"{s['loss_rel']:.2e}), gradient max diff / max |g| "
            + ", ".join(f"{e:.2e}" for e in s["grad_err"]) for s in out))
    return out


def orbit_presented(ex, **kw):
    """torch_orbit.run(**kw) with every presented frame kept as the host
    image the HUD is drawn on: (stats, {frame: image})."""
    presented = {}
    hud = ex.hud_overlay_np

    def capture(img, lines, **hud_kw):
        presented[int(lines[1].split()[1])] = img.copy()
        return hud(img, lines, **hud_kw)

    ex.hud_overlay_np = capture
    try:
        return ex.run(**kw), presented
    finally:
        ex.hud_overlay_np = hud


def phase_examples(dev):
    """Phase 16: the example programs on the card (examples/torch_*.py),
    each through its run(...) with stdout redirected: render_png (Cornell
    and room at 800x600, 16 warm-up frames), optimize_material (60 steps),
    optimize_camera (80 steps; --joint --edge-aa EX_JOINT_STEPS), orbit
    (Cornell, 72 frames with churn, in flight 2; again in flight 0 and
    with 2 present workers, every presented frame bit-equal; phase 10's
    glTF for EX_GLTF_ORBIT_FRAMES), term_viewer (EX_TERM_FRAMES frames at
    160x96) and parity_report on phase 10's glTF at 1600x1200; each
    program's kernels launched and no plain twin on the card; the loops'
    first steps card vs CPU. Returns the phase's summary."""
    from examples import (torch_optimize_camera, torch_optimize_material,
                          torch_orbit, torch_parity_report, torch_render_png,
                          torch_term_viewer)

    t_phase = time.perf_counter()
    out_dir = os.path.join(REPO, "build", "examples")
    gltf = os.path.join(REPO, "build", "phase10", "scene.glb")
    if not os.path.exists(gltf):
        gltf = real_scene_path()
    summary = {}
    log("phase 16: the example programs")
    with TwinSpy() as spy:
        for scene in ("cornell", "room"):
            name = f"render_png {scene}"
            got, _, s = example_run(
                name, torch_render_png.run, spy, scene=scene,
                out=os.path.join(out_dir, f"render_{scene}.png"),
                device=dev)
            img = got["image"]
            check(img.shape == (600, 800, 4), f"{name}: shape {img.shape}")
            mean = float(img[..., :3].mean()) / 255.0
            check(0.02 < mean < 0.95, f"{name}: mean {mean}")
            s.update(render_s=got["seconds"], frames=got["frames"],
                     fps=got["frames"] / got["seconds"], mean=mean)
            summary[name] = s
            log(f"  {name}: {got['size'][0]}x{got['size'][1]}, "
                f"{got['frames']} frames in "
                f"{got['seconds']:.2f} s ({s['fps']:.2f} frames a second), "
                f"mean {mean:.4f}; wall {s['seconds']:.2f} s")

        got, _, s = example_run("optimize_material",
                                torch_optimize_material.run, spy, device=dev)
        err = got["albedo_err"][-1]
        check(all(math.isfinite(x) for x in got["losses"]),
              "optimize_material: non-finite loss")
        check(err < EX_ALBEDO_ERR, f"optimize_material: max albedo error {err}")
        s.update(ms_a_step=got["seconds"] * 1e3 / len(got["losses"]),
                 loss=[got["losses"][0], got["losses"][-1]],
                 albedo_err=[got["albedo_err"][0], err])
        summary["optimize_material"] = s
        log(f"  optimize_material: {len(got['losses'])} steps, "
            f"{s['ms_a_step']:.1f} ms a step; "
            f"loss {s['loss'][0]:.6f} -> {s['loss'][1]:.6f}; max albedo "
            f"error {s['albedo_err'][0]:.4f} -> {err:.4f}; wall "
            f"{s['seconds']:.2f} s")

        for name, kw in (("optimize_camera", {}),
                         ("optimize_camera joint edge-aa",
                          dict(joint=True, edge_aa=True,
                               steps=EX_JOINT_STEPS))):
            got, _, s = example_run(name, torch_optimize_camera.run, spy,
                                    device=dev, **kw)
            check(all(math.isfinite(x) for x in got["losses"]),
                  f"{name}: non-finite loss")
            check(got["e1"] < got["e0"], f"{name}: pose error "
                  f"{got['e0']} -> {got['e1']}")
            if not kw:
                check(got["result"] == "RECOVERED",
                      f"{name}: pose error {got['e0']} -> {got['e1']}")
            s.update(steps=len(got["losses"]), ms_a_step=got["seconds"] * 1e3
                     / len(got["losses"]), e0=got["e0"], e1=got["e1"],
                     result=got["result"],
                     loss=[got["losses"][0], got["losses"][-1]])
            summary[name] = s
            log(f"  {name}: {s['steps']} steps, {s['ms_a_step']:.1f} ms a "
                f"step; pose error {got['e0']:.4f} -> {got['e1']:.4f} "
                f"({got['result']}); wall {s['seconds']:.2f} s")

        (stats, frames), _, s = example_run(
            "orbit cornell", orbit_presented, spy, ex=torch_orbit,
            out=os.path.join(out_dir, "orbit"), device=dev)
        n = stats["frames"]
        check(stats["churn_frames"] == list(torch_orbit.CHURN),
              f"orbit: churn frames {stats['churn_frames']}")
        check(stats["no_recompile_on_churn"], f"orbit: churn {stats}")
        check(sorted(frames) == list(range(n)), "orbit: frames presented")
        check(all(np.isfinite(f).all() for f in frames.values()),
              "orbit: non-finite frame")
        s.update(stats=stats)
        same = {}
        for inflight, workers in ((0, 1), (2, 2)):
            (st, other), _, _ = example_run(
                "orbit cornell", orbit_presented, spy, ex=torch_orbit,
                out=os.path.join(out_dir, f"orbit_{inflight}_{workers}"),
                no_save=True, inflight=inflight, present_workers=workers,
                device=dev)
            key = f"inflight {inflight}, workers {workers}"
            same[key] = all(np.array_equal(other[f], frames[f])
                            for f in range(n))
            s[key] = {k: st[k] for k in ("steady_fps", "steady_p50_ms",
                                         "churn_frame_ms")}
            check(same[key], f"orbit {key}: presented frames differ from "
                  "in flight 2")
        s["bit_equal"] = same
        summary["orbit cornell"] = s
        log(f"  orbit cornell: {n} frames {stats['resolution']}, steady "
            f"{stats['steady_fps']}"
            f" fps (p50 {stats['steady_p50_ms']} ms), churn frames "
            f"{stats['churn_frames']} {stats['churn_frame_ms']} ms, prewarm "
            f"{stats['prewarm_s']} s; presented frames bit-equal in flight "
            f"0 / 2 workers: {same}; wall {s['seconds']:.2f} s")

        stats, _, s = example_run(
            "orbit gltf", torch_orbit.run, spy, scene=gltf,
            frames=EX_GLTF_ORBIT_FRAMES, out=os.path.join(out_dir, "orbit_gltf"),
            device=dev)
        check(stats["no_recompile_on_churn"], f"orbit gltf: churn {stats}")
        s.update(stats=stats)
        summary["orbit gltf"] = s
        log(f"  orbit gltf: {stats['frames']} frames {stats['resolution']}, "
            f"steady "
            f"{stats['steady_fps']} fps (p50 {stats['steady_p50_ms']} ms), "
            f"prewarm {stats['prewarm_s']} s; wall {s['seconds']:.2f} s")

        with open(os.devnull) as null:
            got, text, s = example_run(
                "term_viewer", torch_term_viewer.run, spy,
                frames=EX_TERM_FRAMES, device=dev, stdin=null)
        last = text.rstrip().splitlines()[-1]
        check(got["frames"] == EX_TERM_FRAMES and last.startswith(
            f"term_viewer: {EX_TERM_FRAMES} frames"), f"term_viewer: {last!r}")
        s.update(frames=got["frames"], fps=got["fps"],
                 ansi_bytes=got["ansi_bytes"], last_line=last.strip())
        summary["term_viewer"] = s
        log(f"  term_viewer: {EX_TERM_FRAMES} frames, {got['fps']:.2f} "
            f"fps, {got['ansi_bytes']} bytes of ANSI a frame; wall "
            f"{s['seconds']:.2f} s")

        got, _, s = example_run(
            "parity_report", torch_parity_report.run, spy, gltf=gltf,
            out=os.path.join(out_dir, "parity_1600x1200.png"), device=dev)
        aux = got["aux_checks"]
        check(got["camera_parity"]["pass"], f"parity_report: camera arm "
              f"{got['camera_parity']}")
        check(aux["finite_ldr"], "parity_report: non-finite ldr")
        s.update(camera_parity=got["camera_parity"], render=got["render"],
                 aux_checks=aux)
        summary["parity_report"] = s
        log(f"  parity_report: camera max |view_proj diff| "
            f"{got['camera_parity']['max_abs_diff_view_proj']:.3g}, "
            f"{'x'.join(map(str, got['setup']['size']))} render (16 + 1 "
            f"frames) {got['render']['seconds']} s, aux "
            f"{aux}; wall {s['seconds']:.2f} s")
        for name, s in summary.items():
            log(f"  {name}: launches {s['launches']}; plain twins on the card "
                f"{s['card_twin_calls']}")

    summary["card_vs_cpu"] = {
        "optimize_material": example_card_vs_cpu(dev, "optimize_material",
                                                 material_steps),
        "optimize_camera": example_card_vs_cpu(dev, "optimize_camera",
                                               pose_steps),
        "optimize_camera joint edge-aa": example_card_vs_cpu(
            dev, "optimize_camera joint edge-aa", pose_steps, joint=True,
            edge_aa=True)}
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16: {summary['seconds']:.1f} s")
    return summary


def main():
    t_start = time.perf_counter()
    seconds = {}     # each phase's wall seconds, for the depth cuts

    def timed(label, fn, *args, **kw):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return result

    check(torch.cuda.is_available(), "no CUDA device available")
    sys.path.insert(0, REPO)
    from sunray_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"phase 1: device {torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi[0])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    path, report = cuda_build.build()
    cuda_build.library()
    log(f"phase 2: built {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    from sunray_tpu_torch import native
    t0 = time.perf_counter()
    native.jpeg_lib()
    jpeg_so = native.library_path(native.JPEG_SOURCE, "libsunray_jpeg")
    log(f"phase 2: built {os.path.relpath(jpeg_so, REPO)} (the JPEG "
        f"encoder, g++) in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    regs = ptxas_registers(report)
    from sunray_tpu_torch.ops import (cuda_boundary, cuda_bvh, cuda_gather,
                                      cuda_trace)
    k1_regs = kernel_registers(regs, "closest_kernel", cuda_trace.CLOSEST_THREADS)
    k5_regs = kernel_registers(regs, "di_spatial_kernel",
                               128)  # csrc/restir.cu kSpatialThreads
    log(f"  registers, resident warps an SM: K1 {k1_regs}, K5 {k5_regs}")
    counts = sass_counts(path)

    kernels = timed("3 kernels", phase_kernels, dev, counts)
    restir_rows, cap = timed("3 K3-K6", phase_restir_kernels, dev, counts)
    kernels.update(restir_rows)
    timed("3 K1/K2 live", phase_trace_live, dev, counts, cap, kernels)
    del cap  # the captured inputs stay out of the frames' peak memory
    kernels["trace_closest"]["registers"] = k1_regs
    kernels["di_spatial"]["registers"] = k5_regs
    kernels.update(timed("3 switches", phase_switch_kernels, dev, counts))
    timed("4 golden", phase_golden, dev)
    # Each kernel's launches are read on its own slice's main path.
    phase5 = {}
    launches = timed("5 restir", phase_main, dev, "restir", CORNELL_KERNELS,
                     n_warm=5, n_timed=20, record=phase5)
    # The frames phase 13 holds exec_paths to: (config, lights, launches,
    # frames), each read on its own run.
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.scene import cornell_box
    cornell_lights = cornell_box(device="cpu").num_lights
    provenance_frames = {"default (phase 5)": (
        RenderConfig(width=1920, height=1080), cornell_lights,
        dict(launches), 25)}
    nee = timed("5 nee", phase_main, dev, "nee", NEE_KERNELS, n_warm=2,
                n_timed=5)
    k2 = kernels["trace_occluded"]
    k2["nee_launches"] = nee["trace_occluded"]
    check(k2["nee_launches"] == 7 * k2["nee_calls_per_frame"],
          f"NEE frame: K2 launched {k2['nee_launches']} times in 7 frames, "
          f"{k2['nee_calls_per_frame']} calls a frame captured")
    log(f"  K2 launches: {launches['trace_occluded']} over 25 ReSTIR frames, "
        f"{k2['nee_launches']} over 7 NEE frames")
    k1 = kernels["trace_closest"]
    k1["nee_launches"] = nee["trace_closest"]
    check(launches["trace_closest"] == 25 * len(RESTIR_CLOSEST),
          f"ReSTIR frame: K1 launched {launches['trace_closest']} times in 25 "
          f"frames, {len(RESTIR_CLOSEST)} calls a frame captured")
    check(k1["nee_launches"] == 7 * k1["nee_calls_per_frame"],
          f"NEE frame: K1 launched {k1['nee_launches']} times in 7 frames, "
          f"{k1['nee_calls_per_frame']} calls a frame captured")
    log(f"  K1 launches: {launches['trace_closest']} over 25 ReSTIR frames, "
        f"{k1['nee_launches']} over 7 NEE frames")
    slice_launches = timed("7 switches", phase_main, dev, "restir",
                           SLICE_KERNELS, n_warm=5, n_timed=20,
                           switches=SWITCHES, absent=("trace_occluded",))
    provenance_frames["switches (phase 7)"] = (
        RenderConfig(width=1920, height=1080, **SWITCHES), cornell_lights,
        dict(slice_launches), 25)
    launches.update({k: slice_launches[k] for k in SWITCH_KERNELS})
    kernels.update(timed("6 K10-K12", phase_binned_kernels, dev))
    timed("6 small", phase_big_small, dev)
    big_launches = timed("6 big", phase_main, dev, "restir", BIG_KERNELS,
                         n_warm=5, n_timed=20, big=True)
    launches.update({k: big_launches[k] for k in BINNED_KERNELS})
    timed("6 vs brute", phase_big_vs_brute, dev)
    # Phase 8 last: its 720p step's peak memory starts from the other
    # phases' tensors released.
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    kernels["gather_rows_bwd"], diff_launches = timed("8 diff", phase_diff,
                                                       dev, gen)
    provenance_frames["differentiable (phase 8)"] = (
        RenderConfig(width=DIFF_SIZE[0], height=DIFF_SIZE[1],
                     differentiable=True), cornell_lights,
        dict(diff_launches), 1)
    launches.update({k: diff_launches[k] for k in DIFF_ONLY})
    kernels["boundary_candidates"], vis_launches, bwd_vis = timed(
        "9 visibility", phase_visibility, dev, gen)
    launches.update({k: vis_launches[k] for k in VIS_ONLY})
    # K8's backward: launches of the step without the terms ("launches")
    # and with them; registers of the widths the step's calls take.
    kernels["gather_rows_bwd"].update(
        vis_calls=bwd_vis, vis_step_launches=vis_launches["gather_rows_bwd"],
        registers={name: v for w in (6, 9, 12) for name, v in
                   kernel_registers(regs, f"gather_rows_bwd_kernelILi{w}ELi4EE",
                                    32 * cuda_gather.BWD_MAX_WARPS).items()})
    kernels["boundary_candidates"]["registers"] = kernel_registers(
        regs, "boundary_candidates_kernelILi8E", cuda_boundary.THREADS)
    real_rows, real_launches = timed("10 real scene", phase_real_scene, dev,
                                     counts)
    for name in REAL_ONLY:
        real_rows[name]["registers"] = kernel_registers(regs, "bvh_walk_kernel",
                                                        cuda_bvh.THREADS)
    kernels.update(real_rows)
    launches.update(real_launches)
    kernels["gather_rows_bwd_runs"], diff_real_launches = timed(
        "11 real diff", phase_real_diff, dev)
    launches.update({k: diff_real_launches[k] for k in RUNS_ONLY})
    configs = timed("12 configs", phase_configs, dev, kernels)
    provenance_frames["bf16 (phase 12)"] = (
        RenderConfig(width=1920, height=1080, **CONFIG_KW["bf16"]),
        cornell_lights, configs["bf16"]["launches_a_frame"],
        CONFIG_WARM + CONFIG_TIMED)
    utilities = timed("13 utilities", phase_utilities, dev,
                      kernels["gather_rows_bwd"]["step_ms"], phase5,
                      provenance_frames)
    viewers, kernels["paint_meshes"], overlay_launches = timed(
        "14 viewers", phase_viewers, dev)
    launches.update({k: overlay_launches[k] for k in OVERLAY_ONLY})
    parallel, par_rows, par_launches = timed("15 parallel", phase_parallel,
                                             dev, phase5["frame_ms"])
    kernels.update({k: par_rows[k] for k in PARALLEL_ONLY})
    launches.update({k: par_launches[k] for k in PARALLEL_ONLY})
    examples = timed("16 examples", phase_examples, dev)

    out = []
    for name, (source, replaces) in KERNELS.items():
        r = kernels[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                 "bound_by": r["bound"][1],
                 "library_ms": r.get("library_ms")}
        for key in ("agree", "rays", "live", "live_restir_frame_ms",
                    "live_restir_frame_bound_ms", "nee_calls_per_frame",
                    "nee_launches", "lights600_ms",
                    "overflow_share", "needed_tests", "rule_tests",
                    "block_items", "old_tests", "dead_ms", "fallback_closest_ms",
                    "fallback_anyhit_ms", "fallback_closest_bound_ms",
                    "fallback_anyhit_bound_ms", "anyhit_ms", "anyhit_bound_ms",
                    "anyhit_plain_ms", "anyhit_dead_ms", "anyhit_needed_tests",
                    "anyhit_rule_tests", "anyhit_old_tests", "nonfma_floor_ms",
                    "taa_corners_ms", "floor_ms", "bypass_share", "live_ms",
                    "live_plain_ms", "live_max_abs_err", "live_bypass_share",
                    "live_bound_ms", "live_floor_ms", "random_ms",
                    "live_nee_frame_ms", "registers", "frames",
                    "frames_ms_spread", "bit_equal_runs", "shape",
                    "err_over_row_abs_sum", "err_over_row_abs_sum_vs_plain",
                    "materials_ms", "materials_bound_ms",
                    "materials_plain_ms", "materials_library_ms",
                    "synthetic_ms", "step_ms", "step_peak_gb", "step_mrays",
                    "step_stages_ms", "checkpoints_off_480x270",
                    "lanes_differing", "needed_ops", "step_launches",
                    "ad_vs_fd", "k_sweep", "vis_calls",
                    "vis_step_launches", "queries", "frame_ms", "frame_mrays",
                    "ldr_mean", "accel_ops", "launches_a_frame",
                    "card_vs_cpu_psnr", "alpha_queries", "queries_a_frame",
                    "index_put_ms", "sort_ms", "hand_sort_ms", "breakdown",
                    "calls", "step_nans",
                    "card_vs_cpu", "big_mesh_step", "bf16_agree",
                    "bf16_max_abs_err", "bf16_ms", "bf16_f32_same_data_ms",
                    "bf16_plain_ms", "bf16_bound_ms", "bf16_bound_by",
                    "bf16_launches_a_frame", "lights578_agree",
                    "lights578_max_abs_err", "lights578_ms",
                    "stress_max_abs_err", "stress_ms", "stress_plain_ms",
                    "stress_bound", "stress_shape",
                    "whole_frame_bit_equal"):
            if key in r:
                entry[key] = r[key]
        out.append(entry)
    log(json.dumps({"configs": configs}))
    log(json.dumps({"utilities": utilities}))
    log(json.dumps({"viewers": viewers}))
    log(json.dumps({"parallel": parallel}))
    log(json.dumps({"examples": examples}))
    log(json.dumps({"phase_seconds": seconds}))
    log(f"wall time {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
