"""K5's order of work, modelled in plain PyTorch on the CPU.

csrc/restir.cu's di_spatial_kernel computes the surface's shading terms
once a flavour (`shade_terms<false>` for the centre and the winner, as
brdf.eval_unshadowed_light rounds; `shade_terms<true>` for the taps, as
brdf.eval_p_hat_planar rounds) and passes them to every target-function
evaluation. `shade_terms` and `eval_light` below are those two
functions, `spatial_merge` the lane's order: the centre draw, the centre
merge, one draw a tap in tap order (a skipped tap's included), each used
tap's merge, the resolve. Its seeds, M and `has` must equal
cuda_restir.di_spatial_plain exactly and every other output bit for bit.
Where the centre won and no tap took, the winner's f_y equals the
centre's bit for bit (the same inputs), so a select could replace the
resolve's evaluation there; the kernel evaluates it on every lane, as
almost no warp has all its lanes keep the centre (PERF.md), and
the model checks the equality. The model must agree with the JAX package's
di_spatial_pallas (interpret mode) at the take-flip tolerance that
tests/test_restir_math.py holds that kernel to. Cases: seeded 32x24
frames with 1, 3 and 5 taps, taps off every image edge, lanes with
`pending` false, centre and neighbour light ids at and above n_lights,
and reservoirs with W = 0. The kernel is held to the plain version on
the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.ops.pallas_restir import di_spatial_pallas
from sunray_tpu_torch.ops import cuda_restir as cr
from sunray_tpu_torch.ops import fp
from sunray_tpu_torch.ops import rng as rng_mod
from sunray_tpu_torch.ops.brdf import INV_PI, PI, safe_sqrt
from torch_di_spatial_cases import FIELDS, N_LIGHTS, di_spatial_args
from torch_parity import check_reservoir, n

# Taps off the left, right, top and bottom edges for most pixels, and
# near ones.
TAPS = {1: [(3, -2)],
        3: [(-40, 1), (5, 30), (-2, 2)],
        5: [(40, 0), (0, -30), (-7, 4), (6, 5), (-1, -9)]}


def _v(x):
    """(P, 3) -> three (P,) components."""
    return [x[:, c] for c in range(3)]


def shade_terms(surf, planar):
    """The terms of the target function that depend on the surface alone
    (csrc/restir.cu shade_terms): ndv and root_v per flavour, the rest
    shared."""
    nrm, view, al = surf["n"], surf["v"], surf["al"]
    ndv = torch.clamp(fp.sum3(nrm, view) if planar else fp.fma(
        nrm[2], view[2], fp.fma(nrm[1], view[1], nrm[0] * view[0])), min=0.001)
    a = surf["rough"] * surf["rough"]
    a2 = a * a
    one_m = 1.0 - a2
    metal = surf["metal"]
    base = 0.04 * (1.0 - metal)
    f0 = [fp.fma(al[c], metal, base) for c in range(3)]
    return dict(ndv=ndv, a2=a2, a2m1=a2 - 1.0, one_m=one_m,
                root_v=fp.sqrt(fp.fma(ndv * ndv, one_m, a2)), f0=f0,
                one_f0=[1.0 - f for f in f0],
                diff=[al[c] * (1.0 - metal) for c in range(3)])


def _dot(a, b, planar):
    return fp.sum3(a, b) if planar else fp.fma(a[2], b[2],
                                                fp.fma(a[1], b[1], a[0] * b[0]))


def _norm(x, planar):
    if planar:
        return safe_sqrt(fp.sum3(x, x))
    return safe_sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])


def eval_light(surf, terms, em, lpos, lnrm, planar):
    """csrc/restir.cu eval_light: f_y of a light sample from the terms."""
    pos, nrm, view = surf["pos"], surf["n"], surf["v"]
    l = [lpos[c] - pos[c] for c in range(3)]
    dist = torch.clamp(_norm(l, planar), min=1e-4)
    l = [x / dist for x in l]
    ndl = torch.clamp(_dot(nrm, l, planar), min=0.0)
    cos_light = torch.clamp(-fp.sum3(lnrm, l) if planar
                            else _dot(lnrm, [-x for x in l], False), min=0.0)
    lit = (ndl > 0.0) & (cos_light > 0.0)
    h = [view[c] + l[c] for c in range(3)]
    h_n = torch.clamp(_norm(h, planar), min=1e-12)
    h = [x / h_n for x in h]
    ndh = torch.clamp(_dot(nrm, h, planar), min=0.0)
    vdh = torch.clamp(_dot(view, h, planar), min=0.0)
    denom = fp.fma(ndh * ndh, terms["a2m1"], 1.0)
    d_term = terms["a2"] / (denom * PI * denom)
    ggx_l = terms["ndv"] * fp.sqrt(fp.fma(ndl * ndl, terms["one_m"],
                                          terms["a2"]))
    v_term = 0.5 / torch.clamp(fp.fma(ndl, terms["root_v"], ggx_l), min=1e-4)
    dv = d_term * v_term
    fres5 = fp.pow5(1.0 - vdh)
    geometry = ndl * cos_light / torch.clamp(dist * dist, min=1e-4)
    out = []
    for c in range(3):
        f = fp.fma(terms["one_f0"][c], fres5, terms["f0"][c])
        shade = fp.fma(dv, f, terms["diff"][c] * (1.0 - f) * INV_PI)
        out.append(torch.where(lit, em[c] * shade * geometry, 0.0))
    return out


def _max3(f):
    return torch.maximum(torch.maximum(f[0], f[1]), f[2])


def spatial_merge(table, seed, center, taps, pending, gnormal, gdepth, cur,
                  pos, normal, view, albedo, rough, metal, width, height,
                  clamps):
    """di_spatial_kernel's lane, on every lane at once: (seed', fields,
    lanes where the centre won and no tap took)."""
    w_clamp, m_clamp, ws_clamp = clamps
    n_l = table.num
    p = pos.shape[0]
    surf = dict(pos=_v(pos), n=_v(normal), v=_v(view), al=_v(albedo),
                rough=rough, metal=metal)
    t_full, t_tap = shade_terms(surf, False), shade_terms(surf, True)

    def em(idx):
        return _v(table.emission[idx.clamp(0, n_l - 1).long()])

    c_raw = center["light_idx"]
    c_ok = pending & (center["W"] > 0.0) & (c_raw < n_l)
    c_idx = torch.clamp(c_raw, max=n_l - 1)
    c_pos, c_nrm = _v(center["light_pos"]), _v(center["light_normal"])
    c_em = em(c_idx)
    f_c = eval_light(surf, t_full, c_em, c_pos, c_nrm, False)
    seed, u_m = rng_mod.rnd(seed)
    zero = torch.zeros((p,))
    w_sum, m_acc, c_take = cr.merge(zero, zero, center["M"],
                                    _max3(f_c) * center["W"] * center["M"],
                                    u_m, c_ok)
    r_idx = torch.where(c_take, c_idx, 0)
    r_pos = [torch.where(c_take, a, 0.0) for a in c_pos]
    r_nrm = [torch.where(c_take, a, 0.0) for a in c_nrm]
    e0 = em(torch.zeros_like(c_idx))
    r_em = [torch.where(c_take, a, b) for a, b in zip(c_em, e0)]
    took = torch.zeros((p,), dtype=torch.bool)
    for dx, dy in taps:
        seed, u = rng_mod.rnd(seed)

        def shift(x):
            return cr.shift_flat(x, dx, dy, height, width)

        ok, _ = cr.neighbour_ok(dx, dy, width, height, normal, cur, gnormal,
                                gdepth)
        w_cl = torch.clamp(shift(center["W"]), max=w_clamp)
        m_cl = torch.clamp(shift(center["M"]), max=m_clamp)
        idx_raw = shift(center["light_idx"])
        use = pending & ok & (w_cl > 0.0) & (idx_raw < n_l)
        idx = torch.clamp(idx_raw, max=n_l - 1)
        lp, ln = _v(shift(center["light_pos"])), _v(shift(center["light_normal"]))
        t_em = em(idx)
        p_hat = _max3(eval_light(surf, t_tap, t_em, lp, ln, True))
        w_sum, m_acc, take = cr.merge(w_sum, m_acc, m_cl, p_hat * w_cl * m_cl,
                                      u, use)
        r_idx = torch.where(take, idx, r_idx)
        r_pos = [torch.where(take, a, b) for a, b in zip(lp, r_pos)]
        r_nrm = [torch.where(take, a, b) for a, b in zip(ln, r_nrm)]
        r_em = [torch.where(take, a, b) for a, b in zip(t_em, r_em)]
        took |= take
    keep = c_take & ~took
    f_y = eval_light(surf, t_full, r_em, r_pos, r_nrm, False)
    for a, b in zip(f_c, f_y):            # the centre's f_y where it is kept
        assert torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))
    w_spatial = torch.clamp(w_sum / torch.clamp(m_acc * _max3(f_y), min=1e-3),
                            max=ws_clamp)
    return seed, dict(light_pos=torch.stack(r_pos, -1),
                      light_normal=torch.stack(r_nrm, -1), w_sum=w_sum,
                      M=m_acc, light_idx=r_idx, w_spatial=w_spatial,
                      f_y_w=torch.stack(f_y, -1),
                      has=pending & (w_sum > 0.0)), keep


@pytest.mark.parametrize("n_taps", sorted(TAPS))
def test_terms_once_is_plain_bit_for_bit(n_taps):
    args = di_spatial_args(TAPS[n_taps], 10 + n_taps)
    ms, mres, keep = spatial_merge(*args)
    ps, pres = cr.di_spatial_plain(*args)
    assert torch.equal(ms, ps)
    for key in FIELDS:
        a, b = mres[key], pres[key]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key
    # the cases the frame is made to hold
    pending, center = args[4], args[2]
    assert (~pending).any() and (center["light_idx"] >= N_LIGHTS).any()
    assert (center["W"] == 0.0).any()
    assert 0.0 < keep.float().mean().item() < 1.0      # centre kept, and not
    assert (pres["M"][~pending] == 0).all() and not pres["has"][~pending].any()


@pytest.mark.parametrize("n_taps", sorted(TAPS))
def test_terms_once_matches_jax(n_taps):
    args = di_spatial_args(TAPS[n_taps], 40 + n_taps)
    (table, seeds, center, taps, pending, gnormal, gdepth, cur, pos, normal,
     view, albedo, rough, metal, width, height, clamps) = args
    ms, mres, _ = spatial_merge(*args)
    n_l = table.num

    def em(idx):
        return table.emission[idx.clamp(0, n_l - 1).long()]

    def jfields(f):
        return {k: jnp.asarray(n(v)) for k, v in f.items()}

    center_j = jfields(dict(center, emission=em(center["light_idx"])))
    taps_j = []
    for dx, dy in taps:
        shifted = {k: cr.shift_flat(v, dx, dy, height, width)
                   for k, v in center.items()}
        ok, _ = cr.neighbour_ok(dx, dy, width, height, normal, cur, gnormal,
                                gdepth)
        taps_j.append((jfields(dict(shifted, emission=em(shifted["light_idx"]))),
                       jnp.asarray(n(ok))))
    js, jres = di_spatial_pallas(
        jnp.asarray(n(seeds).astype(np.uint32)), center_j, taps_j,
        jnp.asarray(n(pending)), *(jnp.asarray(n(x)) for x in (
            pos, normal, view, albedo, rough, metal)), (*clamps, n_l))
    # test_restir_math.py's TestPallasDiSpatialMatches: seeds bit-equal, M
    # exact, w_sum within rtol 5e-4, winners on more than 99% of lanes, and
    # on the lanes whose winner agrees w_spatial and f_y within rtol 1e-3
    # (a grazing lane's target function carries the XLA kernel's rounding
    # of its dot products: up to 4.3e-4 here) and `has` equal.
    agree = check_reservoir(ms, mres, js, jres, w_key=None)
    assert agree > 0.99
    same = n(mres["light_idx"]) == np.asarray(jres["light_idx"])
    for key in ("w_spatial", "f_y_w"):
        np.testing.assert_allclose(n(mres[key])[same],
                                   np.asarray(jres[key])[same], rtol=1e-3,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(n(mres["has"]), np.asarray(jres["has"]))
