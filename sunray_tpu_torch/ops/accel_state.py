"""Acceleration-structure rebuild/refit heuristic — port of
sunray_tpu/ops/accel_state.py (the reference's AsState machine,
acceleration_structure/mod.rs:31-148).

  - ops: SLOW_BUILD (quality build: the host SAH builder), FAST_BUILD
    (the device LBVH), UPDATE (refit the cached topology's boxes);
  - at most MAX_UPDATES_BEFORE_REBUILD refits between rebuilds, and after
    FRAMES_TO_SETTLE quiet frames a quality rebuild settles the structure.
"""

from __future__ import annotations

import dataclasses

SLOW_BUILD = "slow_build"
FAST_BUILD = "fast_build"
UPDATE = "update"

MAX_UPDATES_BEFORE_REBUILD = 8   # mod.rs:75
FRAMES_TO_SETTLE = 16            # mod.rs:78


@dataclasses.dataclass
class AsState:
    """One structure's build-quality state machine."""

    optimal: bool = False          # built with a quality (slow) build
    updates_since_rebuild: int = 0
    quiet_frames: int = 0

    def next_op(self, geometry_changed: bool, topology_changed: bool) -> str:
        """The op for this frame (mod.rs:94-111 adapted): a topology change
        rebuilds fast; movement refits up to 8 times, then rebuilds fast;
        16 quiet frames after a fast build settle with a slow build."""
        if topology_changed:
            return FAST_BUILD
        if geometry_changed:
            if self.updates_since_rebuild >= MAX_UPDATES_BEFORE_REBUILD:
                return FAST_BUILD
            if self.optimal or self.updates_since_rebuild > 0:
                return UPDATE
            return FAST_BUILD
        if not self.optimal and self.quiet_frames >= FRAMES_TO_SETTLE:
            return SLOW_BUILD
        return "none"

    def mark(self, op: str, changed: bool) -> None:
        """Record what happened this frame (mod.rs:122-148)."""
        if changed:
            self.quiet_frames = 0
        else:
            self.quiet_frames += 1
        if op == SLOW_BUILD:
            self.optimal = True
            self.updates_since_rebuild = 0
        elif op == FAST_BUILD:
            self.optimal = False
            self.updates_since_rebuild = 0
        elif op == UPDATE:
            self.updates_since_rebuild += 1
