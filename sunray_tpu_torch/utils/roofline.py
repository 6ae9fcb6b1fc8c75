"""Analytic HBM-traffic lower bound for one frame — the roofline; port of
sunray_tpu/utils/roofline.py.

From the pipeline's dataflow (render/pipeline.py's pass structure), the
minimum bytes one frame must move through HBM assuming perfect
intra-stage fusion: every cross-stage interface array is written once by
its producer and read once per consuming stage; everything inside a stage
stays in registers or shared memory. Dividing by the card's peak HBM
bandwidth gives the frame-time floor the card permits for the workload.

The counting rules are the JAX module's, stage by stage, so the bytes are
equal (tests/test_torch_utils.py); only the bandwidth is the card's:

  - all f32 = 4 B/channel, P = width*height;
  - an interface array of C channels costs 4*P*C to write + 4*P*C per
    stage that reads it;
  - spatial-reuse taps read the tapped channels once per tap;
  - trace-kernel I/O counts rays (origin 3 + dir 3 + tmin/tmax/exclude
    = 9 ch) in and hits (t, tri, u, v = 4 ch) out per traced batch;
    triangle/cluster tables are counted once per frame;
  - temporal state (reservoirs, accum image) is read from last frame's
    buffers and written for the next — both sides count;
  - banded history gathers read each source row-window once (the halo
    rows overlap between bands: counted (band+2*halo)/band per byte).

This is a LOWER bound, not a prediction. H100_HBM_GBPS is the public HBM3
bandwidth of the H100 SXM5 80GB, 3,350 GB/s; a card held below its 700 W
power limit may not reach it.
"""

from __future__ import annotations

import dataclasses

H100_HBM_GBPS = 3350.0  # GB/s, H100 SXM5 80GB HBM3 (public spec)

F32 = 4

# Cross-stage interface widths, in f32 channels (see the dataclasses):
GBUF_CH = 10          # depth 1 + normal 3 + rough 1 + diffuse 3 + motion 2
RES_DI_CH = 13        # render/restir.ReservoirDI
RES_GI_CH = 14        # render/restir.ReservoirGI
PRIMARY_HIT_CH = 19   # gbuffer.PrimaryHit minus gbuf overlap (found, pos 3,
                      # normal 3, albedo 3, rough, metal, view 3, tri, t,
                      # vdist, prev_uv 2  -> conservatively all 19 cols)
RAY_CH = 9            # o 3 + d 3 + tmin + tmax + exclude-id
HIT_CH = 4            # t, tri, u, v
OCC_CH = 1            # occlusion query result


@dataclasses.dataclass
class StageTraffic:
    name: str
    bytes: int
    note: str

    @property
    def mbytes(self) -> float:
        return self.bytes / 1e6

    def floor_ms(self, gbps: float = H100_HBM_GBPS) -> float:
        return self.bytes / (gbps * 1e9) * 1e3


def _mb(p, ch):
    return F32 * p * ch


def frame_traffic_lower_bound(cfg, ris_rounds: int = 2,
                              final_rounds: int = 2) -> list[StageTraffic]:
    """Per-stage unavoidable HBM bytes for one frame of the full ReSTIR
    pipeline at cfg's resolution. ris_rounds/final_rounds: the
    data-dependent walk-round counts actually executed (bench aux);
    Cornell steady state runs 2/2."""
    p = cfg.width * cfg.height
    stages: list[StageTraffic] = []

    # --- Pass 1: RIS/G-buffer (render/gbuffer.ris_pass) ----------------
    # Trace I/O: ris_rounds closest-hit batches (primary + virtual
    # bounces) + DI visibility + GI bounce + GI NEE shadow.
    trace1 = ris_rounds * _mb(p, RAY_CH + HIT_CH) + \
        2 * _mb(p, RAY_CH + OCC_CH) + _mb(p, RAY_CH + HIT_CH)
    # Temporal reuse reads last frame's reservoirs (banded gather,
    # halo overlap factor) and writes this frame's.
    band, halo = max(cfg.history_gather_band, 1), cfg.history_gather_halo
    halo_f = (band + 2.0 * halo) / band if cfg.history_gather_band else 1.0
    res_rw = halo_f * (_mb(p, RES_DI_CH) + _mb(p, RES_GI_CH)) \
        + _mb(p, RES_DI_CH) + _mb(p, RES_GI_CH)
    # Interface writes consumed by pass 2: G-buffer + PrimaryHit.
    iface_w = _mb(p, GBUF_CH + PRIMARY_HIT_CH)
    stages.append(StageTraffic(
        "ris_pass", int(trace1 + res_rw + iface_w),
        f"{ris_rounds} walk rounds + 3 aux traces + temporal reservoir "
        f"r/w (halo x{halo_f:.1f}) + gbuf/hit interface"))

    # --- Pass 2: final trace + ReSTIR spatial reuse ---------------------
    # Reads the pass-1 interface once.
    iface_r = _mb(p, GBUF_CH + PRIMARY_HIT_CH)
    # DI spatial: center + N taps read the tapped DI channels (pos 3,
    # normal 3, W, M, idx = 9 ch per tap); 1 winner visibility ray.
    di = cfg.di_spatial_samples * _mb(p, 9) + _mb(p, RAY_CH + OCC_CH)
    # GI spatial: N taps of GI channels (pos 3, radiance 3, normal 3, W,
    # M, depth, hit_normal 3 = 14) + per-tap visibility ray + final.
    gi = cfg.gi_spatial_samples * (
        _mb(p, RES_GI_CH) + _mb(p, RAY_CH + OCC_CH)
    ) + _mb(p, RAY_CH + OCC_CH)
    # Later-bounce walk rounds: trace I/O per round (round 0 reuses the
    # stored primary hit — bench.py ray accounting).
    trace2 = max(final_rounds - 1, 0) * _mb(p, RAY_CH + HIT_CH)
    # NEE shadow rays on later rough bounces ride inside the rounds'
    # masked batches (already counted by RAY_CH on those rounds).
    raw_w = _mb(p, 3)
    stages.append(StageTraffic(
        "final_pass", int(iface_r + di + gi + trace2 + raw_w),
        f"iface read + DI {cfg.di_spatial_samples} taps + GI "
        f"{cfg.gi_spatial_samples} taps+vis + {max(final_rounds - 1, 0)} "
        f"bounce rounds + raw write"))

    # --- TAA (postprocess.temporal_accumulate) --------------------------
    if cfg.enable_taa:
        band = max(cfg.history_gather_band, 1)
        halo_f = (band + 2.0 * cfg.history_gather_halo) / band \
            if cfg.history_gather_band else 1.0
        taa = _mb(p, 3) + _mb(p, 2) + halo_f * _mb(p, 3) + _mb(p, 3)
        stages.append(StageTraffic(
            "taa", int(taa),
            f"raw+motion read, history gather (x{halo_f:.1f}), accum write"))

    # --- A-trous denoise (postprocess.atrous_denoise) -------------------
    if cfg.denoise_passes > 0:
        guides = 8  # depth 1 + normal 3 + rough 1 + diffuse 3
        per_pass = _mb(p, 3) + _mb(p, guides) + _mb(p, 3)
        stages.append(StageTraffic(
            "denoise", int(cfg.denoise_passes * per_pass),
            f"{cfg.denoise_passes} passes x (color r/w + {guides}ch guides)"))

    # --- Postprocess (tonemap) ------------------------------------------
    stages.append(StageTraffic(
        "postprocess", int(2 * _mb(p, 3)), "read HDR, write LDR"))

    return stages


def total_floor_ms(stages: list[StageTraffic],
                   gbps: float = H100_HBM_GBPS) -> float:
    return sum(s.bytes for s in stages) / (gbps * 1e9) * 1e3


def roofline_report(cfg, measured_ms: float | None = None,
                    ris_rounds: int = 2, final_rounds: int = 2,
                    gbps: float = H100_HBM_GBPS) -> dict:
    """The machine-readable roofline record (chip_smoke.py phase 13)."""
    stages = frame_traffic_lower_bound(cfg, ris_rounds, final_rounds)
    total_bytes = sum(s.bytes for s in stages)
    floor = total_floor_ms(stages, gbps)
    rep = {
        "resolution": f"{cfg.width}x{cfg.height}",
        "hbm_peak_gbps": gbps,
        "stages": [
            {"stage": s.name, "mbytes": round(s.mbytes, 1),
             "floor_ms": round(s.floor_ms(gbps), 2), "note": s.note}
            for s in stages
        ],
        "total_mbytes": round(total_bytes / 1e6, 1),
        "floor_ms": round(floor, 2),
    }
    if measured_ms is not None:
        rep["measured_ms"] = round(measured_ms, 2)
        # Fraction of peak HBM bandwidth the frame achieves IF it moves
        # exactly the lower-bound bytes; the true achieved fraction is
        # higher (real traffic > bound), so this is the conservative
        # "how far from the floor" number.
        rep["floor_fraction"] = round(floor / measured_ms, 3)
    return rep
