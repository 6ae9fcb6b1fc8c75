"""BRDF math: ONB, GGX VNDF sampling, cosine hemisphere, and the ReSTIR
target functions (unshadowed light, GI target pdf, their planar forms).

Port of sunray_tpu/ops/brdf.py, formula for formula (rt_utils.slang:
150-263). All functions broadcast over leading dims; vectors are
(..., 3).

The target functions round as XLA's CPU backend compiles the reference
(ops/fp.py): a division by PI is a multiply by float32(1 / PI); a
multiply feeding an add is fused where the multiply has no other use
(a per-pixel factor broadcast over the three channels, such as
0.04 * (1 - metal), has other uses); which of two products is fused
was read off XLA's results and is pinned by tests/test_torch_restir.py;
jnp.sum over a 3-vector is the chain
fma(x2, y2, fma(x1, y1, x0 * y0)), except a sum of squares of a vector
computed in the same fusion (vec_norm), which XLA leaves unfused; a
sum written out as x0*y0 + x1*y1 + x2*y2 is
fma(x2, y2, fma(x0, y0, x1 * y1)) (fp.sum3).
The planar forms take lists of three component tensors that broadcast
(surface attributes (P,) against sample planes (K, P)), as the JAX
planar forms do.

bf16 shading attributes (cfg.shading_dtype="bf16"): each target
function takes the bfloat16 normal, view, albedo, roughness and metallic
planes the JAX frame casts (gbuffer.py:280-295, pathtrace.py:494-501)
and rounds as XLA's CPU backend compiles the jnp code (read off the
optimized HLO): an operation between two bf16 operands, or a bf16
operand and a Python scalar (which keeps bf16: 0.04, 0.001 and PI are
rounded to bf16 first), is computed in float32 from the bf16-rounded
operands; its result is rounded to bf16 where another bf16 operation
reads it, and read unrounded where a float32 operation does (the
convert pair that JAX's promotion inserts is folded away). jnp.sum of
bf16 products sums the exact products in float32. Positions, distances
and everything mixed with them stay float32.

A differentiable bf16 frame carries the attributes as bf16_carrier
tensors (float64 holding bf16 values) and says so with bf16=True, which
every target function takes (cfg.shading_dtype decides it, as
render/shade.shading_planes does; a float64 tensor alone is never read
as bf16). It takes the same forward; the material terms' backwards (_MaterialBf16,
_PlanarMaterialBf16, _GiDiffuseBf16, _GiDiffusePlanarBf16) round as XLA's
CPU compile of the JAX VJP does (read off its optimized HLO): a bf16
cotangent arriving from float32 is rounded (summed over a plane's
samples first), every product and partial sum of a bf16 transpose is
rounded, and a result that the reference reads only through a convert to
float32 is left unrounded. The other bf16 chains (NdotV, the Smith and
GGX terms) keep autograd's backward through rb, which rounds the
cotangent at each rounding point.
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops import fp

PI = 3.14159  # the reference uses 3.14159 (not pi) throughout
PI_VNDF = 3.14159265  # sample_ggx_vndf uses the longer constant (rt_utils.slang:192)
# float32(1 / float32(PI)): XLA turns x / PI into x * INV_PI.
INV_PI = torch.tensor(1.0, dtype=torch.float32).div(
    torch.tensor(PI, dtype=torch.float32)).item()


# bf16 constants of the bf16 shading path (module docstring).
BF16 = torch.bfloat16


def _bf(v: float) -> float:
    return float(torch.tensor(v, dtype=BF16))


BF_0P04, BF_0P001 = _bf(0.04), _bf(0.001)
# float32(1 / bf16(PI)): a bf16 x / PI compiles to x * INV_PI_BF16.
INV_PI_BF16 = torch.tensor(1.0, dtype=torch.float32).div(
    torch.tensor(_bf(PI), dtype=torch.float32)).item()


def rb(x):
    """x rounded to bfloat16 (nearest even), held in float32."""
    return x.to(BF16).to(torch.float32)


class _Bf16Carrier(torch.autograd.Function):
    """x rounded to bf16 and held in float64 (bf16_carrier)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(BF16).to(torch.float64)

    @staticmethod
    def backward(ctx, g):
        return rb(g.to(torch.float32))


def bf16_carrier(x):
    """The bf16 shading attribute of a differentiable frame: x rounded to
    bf16, carried in float64. The target functions read it as they read a
    bf16 tensor when the caller passes bf16=True, and their backwards (the _*Bf16 Functions)
    return cotangents that the reference leaves unrounded where XLA folds
    a bf16 result into a float32 consumer; the cotangents of the
    attribute's consumers are summed exactly here and rounded to bf16
    once, where the reference sums them in bf16 in its own order (a bf16
    tensor would round each of them, and each partial sum, in autograd's
    order)."""
    return _Bf16Carrier.apply(x)


def is_bf16(x, bf16=False) -> bool:
    """A bf16 shading attribute: the caller says so (bf16=True, which a
    bf16_carrier needs), or x is a bfloat16 tensor."""
    return bf16 or (torch.is_tensor(x) and x.dtype == BF16)


def dot(a, b):
    return fp.dot(a, b)


def safe_sqrt(x, eps=1e-20):
    """sqrt with a finite gradient at 0."""
    return fp.sqrt(torch.clamp(x, min=eps))


def vec_norm(v, eps=1e-20):
    """Gradient-safe vector norm; the squares summed unfused."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return safe_sqrt(x * x + y * y + z * z, eps)


def normalize(v, eps=0.0):
    n = vec_norm(v)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


cross = fp.cross


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    """GLSL refract. Returns zero vector on total internal reflection."""
    cosi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    r = eta[..., None] * i - (eta * cosi + safe_sqrt(k))[..., None] * n
    return torch.where(tir[..., None], torch.zeros_like(r), r)


def build_onb(n):
    """Branchless ONB (rt_utils.slang:150-156, Duff et al.). -> (t, b)."""
    sign_n = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign_n + n[..., 2])
    bb = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [
            1.0 + sign_n * n[..., 0] * n[..., 0] * a,
            sign_n * bb,
            -sign_n * n[..., 0],
        ],
        dim=-1,
    )
    b = torch.stack(
        [bb, sign_n + n[..., 1] * n[..., 1] * a, -n[..., 1]],
        dim=-1,
    )
    return t, b


def smith_g1_ggx(NdotX, alpha):
    """rt_utils.slang:165-169."""
    a2 = alpha * alpha
    denom = NdotX + fp.sqrt(a2 + (1.0 - a2) * NdotX * NdotX)
    return 2.0 * NdotX / torch.clamp(denom, min=1e-4)


def cosine_hemisphere(normal, r1, r2):
    """get_random_bounce (rt_utils.slang:171-177)."""
    phi = 2.0 * PI * r1
    r = fp.sqrt(r2)
    u, v = build_onb(normal)
    d = (
        u * (fp.cos(phi) * r)[..., None]
        + v * (fp.sin(phi) * r)[..., None]
        + normal * safe_sqrt(1.0 - r2)[..., None]
    )
    return normalize(d)


def sample_ggx_vndf(normal, v_world, roughness, r1, r2, differentiable=False,
                    peeled=False):
    """Heitz VNDF half-vector sampling (rt_utils.slang:179-201).

    `differentiable`: rounded as XLA's CPU compile of a differentiable
    frame rounds it: p2's blend with its right product fused, the last
    root's argument as fma(-p2, p2, 1 - p1 * p1), and 1 - p1 * p1 (shared
    by both roots) fused inside the bounce loop's body but not in its
    peeled first round (`peeled`). Where (1 - s) is 1 the last argument is
    the exact residual of a root, whose sign decides the NaN of
    jnp.maximum's gradient. Otherwise each product rounded on its own,
    the rounding that the plain frames' tests hold to the reference."""
    t, b = build_onb(normal)
    vl = torch.stack(
        [dot(v_world, t), dot(v_world, b), dot(v_world, normal)], dim=-1
    )
    a = torch.clamp(roughness * roughness, min=0.001)
    vh = normalize(
        torch.stack([a * vl[..., 0], a * vl[..., 1], vl[..., 2]], dim=-1)
    )

    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.where(
        lensq > 0.0, 1.0 / fp.sqrt(torch.clamp(lensq, min=1e-30)), 0.0
    )
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], dim=-1)
        * inv_len[..., None],
        torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device),
    )
    t2 = cross(vh, t1)

    rr = fp.sqrt(r1)
    phi = 2.0 * PI_VNDF * r2
    p1 = rr * fp.cos(phi)
    p2 = rr * fp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    if differentiable:
        r = 1.0 - p1 * p1 if peeled else fp.fma(-p1, p1, 1.0)
        p2 = fp.fma(s, p2, (1.0 - s) * fp.sqrt(torch.clamp(r, min=0.0)))
        # jnp.maximum's gradient: where the argument is 0 or below, the
        # root's inf slope times 1/2 or 0 is NaN in the reference.
        w = fp.maximum(fp.fma(-p2, p2, r), 0.0)
    else:
        p2 = (1.0 - s) * fp.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
        w = torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0)

    nh = p1[..., None] * t1 + p2[..., None] * t2 + fp.sqrt(w)[..., None] * vh
    hl = normalize(
        torch.stack(
            [a * nh[..., 0], a * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)],
            dim=-1,
        )
    )
    return t * hl[..., 0:1] + b * hl[..., 1:2] + normal * hl[..., 2:3]


def smith_v_ggx(NdotV, NdotL, alpha):
    """rt_utils.slang:158-163."""
    a2 = alpha * alpha
    ggx_l = NdotV * fp.sqrt(fp.fma(NdotL * NdotL, 1.0 - a2, a2))
    root_v = fp.sqrt(fp.fma(NdotV * NdotV, 1.0 - a2, a2))
    return 0.5 / torch.clamp(fp.fma(NdotL, root_v, ggx_l), min=1e-4)


def _fresnel_mix(f0, vdh):
    """f0 + (1 - f0) * (1 - VdotH)^5, fused."""
    return fp.fma(1.0 - f0, fp.pow5(1.0 - vdh), f0)


def eval_unshadowed_light(hit_pos, hit_normal, v_view, hit_albedo, roughness,
                          metallic, light_emission, light_pos, light_normal,
                          bf16=False):
    """Unshadowed direct-light contribution (rt_utils.slang:203-234): GGX
    D*V*F specular + Lambert diffuse, times NdotL * cos_light / dist^2.
    Returns (..., 3) RGB. bf16 attributes (bfloat16 tensors, or carriers
    with bf16=True) take the bf16 rounding."""
    if is_bf16(hit_normal, bf16):
        return _eval_unshadowed_light_bf16(
            hit_pos, hit_normal, v_view, hit_albedo, roughness, metallic,
            light_emission, light_pos, light_normal)
    l = light_pos - hit_pos
    dist = torch.clamp(vec_norm(l), min=1e-4)
    l = l / dist[..., None]
    ndl = torch.clamp(dot(hit_normal, l), min=0.0)
    cos_light = torch.clamp(dot(light_normal, -l), min=0.0)
    lit = (ndl > 0.0) & (cos_light > 0.0)
    h = normalize(v_view + l, eps=1e-12)
    ndh = torch.clamp(dot(hit_normal, h), min=0.0)
    vdh = torch.clamp(dot(v_view, h), min=0.0)
    ndv = torch.clamp(dot(hit_normal, v_view), min=0.001)

    a = roughness * roughness
    a2 = a * a
    denom = fp.fma(ndh * ndh, a2 - 1.0, 1.0)
    d_term = a2 / (denom * PI * denom)
    m = metallic[..., None]
    f0 = fp.fma(hit_albedo, m, 0.04 * (1.0 - m))
    f = _fresnel_mix(f0, vdh[..., None])
    dv = (d_term * smith_v_ggx(ndv, ndl, a))[..., None]
    shade = fp.fma(dv, f, hit_albedo * (1.0 - m) * (1.0 - f) * INV_PI)
    geometry = ndl * cos_light / torch.clamp(dist * dist, min=1e-4)
    out = light_emission * shade * geometry[..., None]
    return torch.where(lit[..., None], out, 0.0)


def _smith_v_bf16(ndv, ndl, a2):
    """smith_v_ggx with NdotV and alpha^2 bf16 (a2: the unrounded square
    of the rounded alpha): ggx_v's root is a bf16 chain, ggx_l's float32,
    and the sum fuses ggx_l's product (the float32 form fuses ggx_v's)."""
    a2r = rb(a2)
    root_v = fp.sqrt(rb(rb(rb(ndv * ndv) * rb(1.0 - a2r)) + a2r))
    root_l = fp.sqrt(fp.fma(ndl * ndl, 1.0 - a2r, a2))
    return 0.5 / torch.clamp(fp.fma(ndv, root_l, ndl * root_v), min=1e-4)


def _d_ggx_bf16(ndh, a2):
    """GGX D with alpha^2 bf16: a2 - 1 from the rounded a2, the division
    by the unrounded one."""
    denom = fp.fma(ndh * ndh, rb(a2) - 1.0, 1.0)
    return a2 / (denom * PI * denom)


def _eval_unshadowed_light_bf16(hit_pos, hit_normal, v_view, hit_albedo,
                                roughness, metallic, light_emission,
                                light_pos, light_normal):
    """eval_unshadowed_light with bf16 shading attributes (module
    docstring's rounding)."""
    n, v, al, r, m = (x.float() for x in (hit_normal, v_view, hit_albedo,
                                          roughness, metallic))
    l = light_pos - hit_pos
    dist = torch.clamp(vec_norm(l), min=1e-4)
    l = l / dist[..., None]
    ndl = torch.clamp(dot(n, l), min=0.0)
    cos_light = torch.clamp(dot(light_normal, -l), min=0.0)
    lit = (ndl > 0.0) & (cos_light > 0.0)
    h = normalize(v + l, eps=1e-12)
    ndh = torch.clamp(dot(n, h), min=0.0)
    vdh = torch.clamp(dot(v, h), min=0.0)
    ndv = torch.clamp(rb(dot(n, v)), min=BF_0P001)

    a = rb(r * r)
    a2 = a * a
    d_term = _d_ggx_bf16(ndh, a2)
    f0, one_m_f0, al_m1 = _MaterialBf16.apply(m, al)
    f = fp.fma(one_m_f0, fp.pow5(1.0 - vdh)[..., None], f0)
    dv = (d_term * _smith_v_bf16(ndv, ndl, a2))[..., None]
    shade = fp.fma(dv, f, al_m1 * (1.0 - f) * INV_PI)
    geometry = ndl * cos_light / torch.clamp(dist * dist, min=1e-4)
    out = light_emission * shade * geometry[..., None]
    return torch.where(lit[..., None], out, 0.0)


class _GiDiffuseBf16(torch.autograd.Function):
    """gi_target_pdf's bf16 f_diffuse = albedo * (1 - metallic) / PI, with
    the backward of XLA's CPU compile of the JAX VJP: the cotangent
    rounded to bf16, divided by PI (a multiply by the float32 reciprocal,
    rounded), each channel's product with the albedo rounded and summed
    over the channels with each partial sum rounded; the albedo's
    cotangent is the unrounded product."""

    @staticmethod
    def forward(ctx, albedo, metallic):
        m1 = rb(1.0 - metallic)[..., None]
        ctx.save_for_backward(albedo, m1)
        return rb(albedo * m1) * INV_PI_BF16

    @staticmethod
    def backward(ctx, g):
        albedo, m1 = ctx.saved_tensors
        cx = rb(rb(g) * INV_PI_BF16)
        cy = rb(albedo * cx)
        s = rb(rb(cy[..., 0] + cy[..., 1]) + cy[..., 2])
        return cx * m1, -s


class _GiDiffusePlanarBf16(torch.autograd.Function):
    """gi_target_pdf_planar's bf16 f_diffuse planes al[c] * (1 - metal) /
    PI, with the backward of XLA's CPU compile of the JAX VJP: each
    channel's cotangent (summed over the samples in float32) rounded,
    divided by PI and rounded; the albedo's cotangent the rounded product
    with 1 - metal; the metal's the rounded products with the albedo,
    negated and summed from the last channel to the first, each partial
    sum rounded."""

    @staticmethod
    def forward(ctx, metal, *al):
        m1 = rb(1.0 - metal)
        ctx.save_for_backward(m1, *al)
        return tuple(rb(a * m1) * INV_PI_BF16 for a in al)

    @staticmethod
    def backward(ctx, *g):
        m1, *al = ctx.saved_tensors
        cx = [rb(rb(gc) * INV_PI_BF16) for gc in g]
        neg = [-rb(a * c) for a, c in zip(al, cx)]
        g_metal = rb(rb(neg[2] + neg[1]) + neg[0])
        return (g_metal, *(rb(c * m1) for c in cx))


def _sum3_bf16(x):
    """A bf16 sum over the last axis (size 3) as XLA's CPU reduce runs it:
    left to right, each partial sum rounded."""
    return rb(rb(x[..., 0] + x[..., 1]) + x[..., 2])


class _MaterialBf16(torch.autograd.Function):
    """The bf16 material terms of eval_unshadowed_light: f0 = 0.04 (1 - m)
    + albedo * m, 1 - f0 (from the rounded f0) and albedo * (1 - m), with
    the backward of XLA's CPU compile of the JAX VJP: each term's
    cotangent rounded to bf16 (f0's as rb(rb(direct) - rb(through
    1 - f0))), every product with an attribute rounded, the sums over the
    channels as _sum3_bf16; the metallic's diffuse and albedo terms summed
    and rounded before the 0.04 term is added, and the last sums (the
    metallic's and the albedo's two terms) left unrounded."""

    @staticmethod
    def forward(ctx, metallic, albedo):
        m = metallic[..., None]
        m1 = rb(1.0 - m)
        f0 = rb(BF_0P04 * m1) + rb(albedo * m)
        ctx.save_for_backward(m, m1, albedo)
        return f0, 1.0 - rb(f0), albedo * m1

    @staticmethod
    def backward(ctx, g_f0, g_omf0, g_alm1):
        m, m1, albedo = ctx.saved_tensors

        def ct(x):
            return torch.zeros_like(albedo) if x is None else rb(x)

        f_ct = rb(ct(g_f0) - ct(g_omf0))
        d_ct = ct(g_alm1)
        acc = rb(-_sum3_bf16(rb(albedo * d_ct))
                 + _sum3_bf16(rb(albedo * f_ct)))
        g_m = acc - rb(_sum3_bf16(f_ct) * BF_0P04)
        return g_m, rb(d_ct * m1) + rb(f_ct * m)


def luminance_max(rgb):
    """p_hat = max channel (the ReSTIR target function)."""
    return rgb.amax(dim=-1)


def gi_target_pdf(shade_pos, shade_normal, albedo, metallic, sample_pos,
                  sample_radiance, bf16=False):
    """rt_utils.slang:255-263. bf16 attributes take the bf16 rounding (as
    eval_unshadowed_light)."""
    w = sample_pos - shade_pos
    d = torch.clamp(vec_norm(w), min=1e-4)
    if is_bf16(shade_normal, bf16):
        ndl = torch.clamp(dot(shade_normal.float(), w / d[..., None]),
                          min=0.0)
        f_diffuse = _GiDiffuseBf16.apply(albedo.float(), metallic.float())
        return (sample_radiance * f_diffuse * ndl[..., None]).amax(dim=-1)
    ndl = torch.clamp(dot(shade_normal, w / d[..., None]), min=0.0)
    f_diffuse = albedo * (1.0 - metallic[..., None]) * INV_PI
    return (sample_radiance * f_diffuse * ndl[..., None]).amax(dim=-1)


def eval_p_hat_planar(px, nx, vx, al, rough, metal, em, lpos, lnrm,
                      bf16=False):
    """Planar form of eval_unshadowed_light -> p_hat (brdf.py:197-252):
    px/nx/vx/al and lpos/lnrm/em are lists of three broadcasting component
    planes, rough/metal single planes. Returns (p_hat, lit, [f_r, f_g, f_b]).
    The same formulas as eval_unshadowed_light with the planar roundings
    (fp.sum3 for the written-out dot products). bf16 attributes take the
    bf16 rounding (as eval_unshadowed_light)."""
    if is_bf16(nx[0], bf16):
        return _eval_p_hat_planar_bf16(px, nx, vx, al, rough, metal, em, lpos,
                                       lnrm)
    l = [lpos[a] - px[a] for a in range(3)]
    dist = torch.clamp(safe_sqrt(fp.sum3(l, l)), min=1e-4)
    l = [l[a] / dist for a in range(3)]
    ndl = torch.clamp(fp.sum3(nx, l), min=0.0)
    cos_light = torch.clamp(-fp.sum3(lnrm, l), min=0.0)
    lit = (ndl > 0.0) & (cos_light > 0.0)
    h = [vx[a] + l[a] for a in range(3)]
    h_n = torch.clamp(safe_sqrt(fp.sum3(h, h)), min=1e-12)
    h = [h[a] / h_n for a in range(3)]
    ndh = torch.clamp(fp.sum3(nx, h), min=0.0)
    vdh = torch.clamp(fp.sum3(vx, h), min=0.0)
    ndv = torch.clamp(fp.sum3(nx, vx), min=0.001)
    a_r = rough * rough
    a2 = a_r * a_r
    denom = fp.fma(ndh * ndh, a2 - 1.0, 1.0)
    d_term = a2 / (denom * PI * denom)
    one_m = 1.0 - a2
    ggx_l = ndv * fp.sqrt(fp.fma(ndl * ndl, one_m, a2))
    root_v = fp.sqrt(fp.fma(ndv * ndv, one_m, a2))
    v_term = 0.5 / torch.clamp(fp.fma(ndl, root_v, ggx_l), min=1e-4)
    fres5 = fp.pow5(1.0 - vdh)
    geometry = ndl * cos_light / torch.clamp(dist * dist, min=1e-4)
    dv = d_term * v_term
    base = 0.04 * (1.0 - metal)
    p_hat = None
    fc = []
    for c in range(3):
        f0 = fp.fma(al[c], metal, base)
        f = fp.fma(1.0 - f0, fres5, f0)
        shade = fp.fma(dv, f, al[c] * (1.0 - metal) * (1.0 - f) * INV_PI)
        out_c = torch.where(lit, em[c] * shade * geometry, 0.0)
        fc.append(out_c)
        p_hat = out_c if p_hat is None else torch.maximum(p_hat, out_c)
    return p_hat, lit, fc


def _eval_p_hat_planar_bf16(px, nx, vx, al, rough, metal, em, lpos, lnrm):
    """eval_p_hat_planar with bf16 surface attributes: the written-out
    NdotV is a bf16 chain (each product and sum rounded)."""
    nx, vx, al = ([x.float() for x in v] for v in (nx, vx, al))
    rough, metal = rough.float(), metal.float()
    l = [lpos[a] - px[a] for a in range(3)]
    dist = torch.clamp(safe_sqrt(fp.sum3(l, l)), min=1e-4)
    l = [l[a] / dist for a in range(3)]
    ndl = torch.clamp(fp.sum3(nx, l), min=0.0)
    cos_light = torch.clamp(-fp.sum3(lnrm, l), min=0.0)
    lit = (ndl > 0.0) & (cos_light > 0.0)
    h = [vx[a] + l[a] for a in range(3)]
    h_n = torch.clamp(safe_sqrt(fp.sum3(h, h)), min=1e-12)
    h = [h[a] / h_n for a in range(3)]
    ndh = torch.clamp(fp.sum3(nx, h), min=0.0)
    vdh = torch.clamp(fp.sum3(vx, h), min=0.0)
    ndv = torch.clamp(rb(rb(rb(nx[0] * vx[0]) + rb(nx[1] * vx[1]))
                         + rb(nx[2] * vx[2])), min=BF_0P001)
    a_r = rb(rough * rough)
    a2 = a_r * a_r
    d_term = _d_ggx_bf16(ndh, a2)
    dv = d_term * _smith_v_bf16(ndv, ndl, a2)
    fres5 = fp.pow5(1.0 - vdh)
    geometry = ndl * cos_light / torch.clamp(dist * dist, min=1e-4)
    mat = _PlanarMaterialBf16.apply(metal, *al)
    p_hat = None
    fc = []
    for c in range(3):
        f0, one_m_f0, al_m1 = mat[c], mat[3 + c], mat[6 + c]
        f = fp.fma(one_m_f0, fres5, f0)
        shade = fp.fma(dv, f, al_m1 * (1.0 - f) * INV_PI)
        out_c = torch.where(lit, em[c] * shade * geometry, 0.0)
        fc.append(out_c)
        p_hat = out_c if p_hat is None else torch.maximum(p_hat, out_c)
    return p_hat, lit, fc


class _PlanarMaterialBf16(torch.autograd.Function):
    """The bf16 material terms of eval_p_hat_planar: for each channel f0 =
    0.04 (1 - metal) + al * metal, 1 - f0 (from the rounded f0) and
    al * (1 - metal), with the backward of XLA's CPU compile of the JAX
    VJP: each term's cotangent (summed over the samples in float32)
    rounded to bf16; f0's as rb(rb(direct) - rb(through 1 - f0)); every
    product with an attribute rounded; the albedo's two terms summed and
    rounded; the metal's summed from the last channel to the first (the
    diffuse term, f0's albedo product, f0's 0.04 product), each partial
    sum rounded."""

    @staticmethod
    def forward(ctx, metal, *al):
        m1 = rb(1.0 - metal)
        base = rb(BF_0P04 * m1)
        f0 = [base + rb(a * metal) for a in al]
        ctx.save_for_backward(metal, m1, *al)
        return (*f0, *(1.0 - rb(x) for x in f0), *(a * m1 for a in al))

    @staticmethod
    def backward(ctx, *g):
        metal, m1, *al = ctx.saved_tensors

        def ct(x):
            return torch.zeros_like(metal) if x is None else rb(x)

        f_ct = [rb(ct(g[c]) - ct(g[3 + c])) for c in range(3)]
        d_ct = [ct(g[6 + c]) for c in range(3)]
        g_al = [rb(rb(d_ct[c] * m1) + rb(f_ct[c] * metal)) for c in range(3)]
        acc = None
        for c in (2, 1, 0):
            diffuse = -rb(al[c] * d_ct[c])
            acc = diffuse if acc is None else rb(acc + diffuse)
            acc = rb(acc + rb(al[c] * f_ct[c]))
            acc = rb(acc - rb(f_ct[c] * BF_0P04))
        return (acc, *g_al)


def gi_target_pdf_planar(px, nx, al, metal, spos, srad, bf16=False):
    """Planar form of gi_target_pdf (brdf.py:255-270). bf16 attributes take
    the bf16 rounding (as eval_unshadowed_light)."""
    w = [spos[a] - px[a] for a in range(3)]
    d = torch.clamp(safe_sqrt(fp.sum3(w, w)), min=1e-4)
    w = [w[a] / d for a in range(3)]
    if is_bf16(nx[0], bf16):
        ndl = torch.clamp(fp.sum3([x.float() for x in nx], w), min=0.0)
        f_diffuse = _GiDiffusePlanarBf16.apply(metal.float(),
                                               *(x.float() for x in al))
        p_hat = None
        for c in range(3):
            contrib = srad[c] * f_diffuse[c] * ndl
            p_hat = contrib if p_hat is None else torch.maximum(p_hat, contrib)
        return p_hat
    ndl = torch.clamp(fp.sum3(nx, w), min=0.0)
    p_hat = None
    for c in range(3):
        contrib = srad[c] * (al[c] * (1.0 - metal) * INV_PI) * ndl
        p_hat = contrib if p_hat is None else torch.maximum(p_hat, contrib)
    return p_hat
