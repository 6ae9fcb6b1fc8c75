"""PyTorch port, the differentiable frame's memory: what autograd keeps for
the backward pass, and the checkpoints that bound it.

A differentiable frame recomputes in the backward pass, rather than
keeps, the walks' rounds after the peeled one, the RIS audition, phase
B's spatial reuse and each plain a-trous pass (ops/loops.checkpointed).
Checked here on the CPU:

  - the gradients are bit-equal with the checkpoints on and off (the
    recompute draws from the same PCG streams and rounds alike), on the
    default differentiable ReSTIR frame (TAA, 4 a-trous passes, ACES) and
    on a NEE frame whose bounce walk runs checkpointed rounds;
  - the bytes kept for the backward, per pixel, of the default
    differentiable ReSTIR frame at 64x36 stay within a budget: the count
    measured with the checkpoints (4.27 KB a pixel) plus 10%. Without them
    it is 24.7 KB; without them, without the float32 backwards of ops/fp
    (autograd through fma's float64 expression) and with the material
    columns gathered one by one, it was 50.6 KB, 19.7 of them float64
    copies.

The count: every tensor autograd saves (saved_tensors_hooks) and every
tensor a checkpoint keeps as its input, still alive when the forward
ends, each storage once.
"""

import dataclasses
import weakref

import pytest
import torch

from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import loops
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene import cornell_box
from torch_parity import CAMERA

KB_PER_PIXEL_BUDGET = 4.70     # 4.27 measured, + 10%


def _params(scene):
    bc = scene.materials.base_color.clone().requires_grad_()
    pos = scene.positions.clone().requires_grad_()
    return dataclasses.replace(
        scene, positions=pos,
        materials=dataclasses.replace(scene.materials, base_color=bc)), (bc,
                                                                         pos)


def _steps(cfg, steps=2, detach=False):
    """loss and gradients w.r.t. base_color and positions of `steps`
    frames, the state threaded through as render_frame returns it (or
    detached by the caller first)."""
    scene, leaves = _params(cornell_box(device="cpu"))
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                           device="cpu")
    state = RenderState.create(cfg, "cpu")
    out = []
    for _ in range(steps):
        state, ldr, aux = render_frame(scene, cfg, state, mats)
        loss = ldr.mean()
        out.append((loss.detach(), torch.autograd.grad(loss, leaves), aux))
        if detach:
            state = state.detach()
    return out


def _passthrough(fn, *args, **kw):
    return fn(*args)


def _no_checkpoints(monkeypatch):
    monkeypatch.setattr(loops, "checkpoint", _passthrough)


CASES = {
    "restir_default": dict(width=32, height=24),
    "nee_walk": dict(width=32, height=24, lighting="nee", bounces=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoints_bit_equal(case, monkeypatch):
    cfg = RenderConfig(differentiable=True, **CASES[case])
    on = _steps(cfg)
    _no_checkpoints(monkeypatch)
    off = _steps(cfg)
    for (l1, g1, aux), (l2, g2, _) in zip(on, off):
        assert torch.equal(l1, l2)
        for a, b in zip(g1, g2):
            assert torch.equal(a, b)
    if case == "nee_walk":     # the bounce walk ran checkpointed rounds
        assert on[-1][2]["final_rounds"] > 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_threaded_without_detach(case):
    """The state render_frame returns carries its frame's graph; the next
    differentiable frame cuts it at its input, as a JAX step's gradients
    stop at the state it takes as an argument. Threading it as returned
    runs (no backward through a freed graph) and gives the gradients of
    a caller that detaches it, bit for bit."""
    cfg = RenderConfig(differentiable=True, **CASES[case])
    kept = _steps(cfg, steps=3)
    cut = _steps(cfg, steps=3, detach=True)
    for (l1, g1, _), (l2, g2, _) in zip(kept, cut):
        assert torch.equal(l1, l2)
        for a, b in zip(g1, g2):
            assert torch.equal(a, b)


def saved_kb_per_pixel(cfg, checkpoints=True):
    """KB a pixel kept for the backward pass of one frame of `cfg` (loss
    mean(ldr), gradients w.r.t. base_color and positions), counted as the
    module docstring says; checkpoints=False runs every checkpointed
    stage as it is."""
    scene, leaves = _params(cornell_box(device="cpu"))
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                           device="cpu")
    refs = []

    def note(x):
        refs.append(weakref.ref(x))
        return x

    inner = loops.checkpoint

    def counting(fn, *args, **kw):
        for a in args:
            vals = a.values() if isinstance(a, dict) else [a]
            for v in vals:
                if torch.is_tensor(v):
                    note(v)
        return inner(fn, *args, **kw)

    loops.checkpoint = counting if checkpoints else _passthrough
    try:
        with torch.autograd.graph.saved_tensors_hooks(note, lambda x: x):
            _, ldr, _ = render_frame(scene, cfg,
                                     RenderState.create(cfg, "cpu"), mats)
            loss = ldr.mean()
        kept = {}
        for r in refs:
            x = r()
            if x is not None:
                kept[x.untyped_storage().data_ptr()] = (
                    x.untyped_storage().nbytes())
        torch.autograd.grad(loss, leaves)
    finally:
        loops.checkpoint = inner
    return sum(kept.values()) / (cfg.width * cfg.height) / 1e3


def test_saved_bytes_per_pixel():
    kb = saved_kb_per_pixel(RenderConfig(width=64, height=36,
                                         differentiable=True))
    assert kb <= KB_PER_PIXEL_BUDGET, f"{kb:.3f} KB a pixel"


def test_stage_checkpoints_save_memory():
    """The same count with every checkpoint off: what they save."""
    cfg = RenderConfig(width=64, height=36, differentiable=True)
    on = saved_kb_per_pixel(cfg)
    off = saved_kb_per_pixel(cfg, checkpoints=False)
    print(f"kept for the backward: {on:.3f} KB a pixel with the "
          f"checkpoints, {off:.3f} without")
    assert off > 3.0 * on, (on, off)
