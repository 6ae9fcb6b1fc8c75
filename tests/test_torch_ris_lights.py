"""K3's per-light records and its candidate loop, modelled in plain PyTorch
on the CPU.

csrc/restir.cu computes each light's 64-byte record once
(light_records_kernel): (v0, em.x), (v1, em.y), (v2, em.z) and (unit
normal, max(L * 0.5 * |cr|, 1e-4)), with the operations and order of
ris_audition_plain; the audition then computes the surface's shading
terms once, reads each candidate's light from its record alone, in the
stream order, and takes by selects. `light_records` builds the records and
`audition_from_records` runs the candidate loop on them. Its seeds, M,
light_idx, w_sum, W, light positions and normals must equal
ris_audition_plain bit for bit, and the JAX package's audition by the
take-flip scheme of tests/test_torch_restir.py: ris_audition_pallas in
interpret mode for tables it fetches exactly (up to 512 lights), the jnp
ris_audition above (the TPU kernel presamples larger tables, which the
port does not). Cases: 1, 2 and 600 lights, one light above the shared-
memory table (RIS_SMEM_LIGHTS + 1, the read-only path on the card), and
disabled lanes, whole warps of them included. The kernel is held to the
plain version on the card in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu.ops.pallas_restir import ris_audition_pallas
from sunray_tpu.render import restir as jr
from sunray_tpu_torch.ops import cuda_restir as cr
from sunray_tpu_torch.ops import fp
from sunray_tpu_torch.ops import rng as rng_mod
from sunray_tpu_torch.ops.brdf import (eval_p_hat_planar,
                                       eval_unshadowed_light, luminance_max,
                                       safe_sqrt)
from torch_parity import check_reservoir, t

FIELDS = ("light_pos", "light_normal", "w_sum", "M", "light_idx", "W")


def light_records(table: cr.LightTable):
    """(L, 4, 4) float32: light_records_kernel's record of each light."""
    v0, v1, v2, em = table
    e1 = [v1[:, a] - v0[:, a] for a in range(3)]
    e2 = [v2[:, a] - v0[:, a] for a in range(3)]
    cr_ = list(fp.cross3(e1, e2))
    cr_n = safe_sqrt(fp.sum3(cr_, cr_))
    area = 0.5 * cr_n
    nn = torch.clamp(cr_n, min=1e-12)
    nrm = torch.stack([cr_[a] / nn for a in range(3)], -1)
    w = torch.clamp(table.num * area, min=1e-4)
    return torch.stack([torch.cat([v0, em[:, 0:1]], 1),
                        torch.cat([v1, em[:, 1:2]], 1),
                        torch.cat([v2, em[:, 2:3]], 1),
                        torch.cat([nrm, w[:, None]], 1)], dim=1)


def audition_from_records(rec, seed, hit_pos, hit_normal, v_view, albedo,
                          roughness, metallic, k, enable):
    """The kernel's candidate loop on the records alone: each candidate's
    draws in the stream order, its target function, then the accumulate
    and the take by selects."""
    p, n_l = hit_pos.shape[0], rec.shape[0]
    seed, draws = rng_mod.rnd_chain(seed, 4 * k)
    draws = draws.T
    surf = [[x[..., a] for a in range(3)]
            for x in (hit_pos, hit_normal, v_view, albedo)]
    zero = torch.zeros((p,), dtype=torch.float32)
    w_sum, r_idx = zero, torch.zeros((p,), dtype=torch.int32)
    r_pos = r_nrm = r_em = [zero] * 3
    for c in range(k):
        u_pick, u1, u2, u_keep = draws[4 * c:4 * c + 4]
        idx = torch.clamp((u_pick * n_l).to(torch.int32), max=n_l - 1)
        q = rec[idx.long()]                     # (P, 4, 4)
        sqr1 = fp.sqrt(u1)
        bu = 1.0 - sqr1
        bv = u2 * sqr1
        bw = 1.0 - bu - bv
        pos = [fp.fma(q[:, 2, a], bw, fp.fma(q[:, 0, a], bu, q[:, 1, a] * bv))
               for a in range(3)]
        nrm = [q[:, 3, a] for a in range(3)]
        em = [q[:, a, 3] for a in range(3)]
        p_hat, _, _ = eval_p_hat_planar(*surf, roughness, metallic, em, pos, nrm)
        wi = torch.where(enable, p_hat * q[:, 3, 3], 0.0)
        w_sum = w_sum + wi
        take = enable & (u_keep < wi / torch.clamp(w_sum, min=1e-4))
        r_idx = torch.where(take, idx, r_idx)
        r_pos = [torch.where(take, a, b) for a, b in zip(pos, r_pos)]
        r_nrm = [torch.where(take, a, b) for a, b in zip(nrm, r_nrm)]
        r_em = [torch.where(take, a, b) for a, b in zip(em, r_em)]
    m = torch.where(enable, float(k), 0.0)
    light_pos, light_normal = torch.stack(r_pos, -1), torch.stack(r_nrm, -1)
    p_hat_w = luminance_max(eval_unshadowed_light(
        hit_pos, hit_normal, v_view, albedo, roughness, metallic,
        torch.stack(r_em, -1), light_pos, light_normal))
    w = w_sum / torch.clamp(m * p_hat_w, min=1e-4)
    return seed, dict(light_pos=light_pos, light_normal=light_normal,
                      w_sum=w_sum, M=m, light_idx=r_idx,
                      W=torch.where(enable & (w_sum > 0.0), w, 0.0))


def _unit(rng, p):
    v = rng.normal(size=(p, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _case(n_lights, p, seed):
    """A random table of n_lights lights and p random surfaces, about 20%
    of lanes disabled and the first 64 (two whole warps) too."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(0, 2, (n_lights, 3)).astype(np.float32)
    tab = [v0, (v0 + rng.uniform(-0.3, 0.3, (n_lights, 3))).astype(np.float32),
           (v0 + rng.uniform(-0.3, 0.3, (n_lights, 3))).astype(np.float32),
           rng.uniform(0, 20, (n_lights, 3)).astype(np.float32)]
    surf = [rng.uniform(0, 2, (p, 3)).astype(np.float32), _unit(rng, p),
            _unit(rng, p), rng.uniform(0, 1, (p, 3)).astype(np.float32),
            rng.uniform(0.05, 1, p).astype(np.float32),
            rng.uniform(0, 1, p).astype(np.float32)]
    seeds = rng.integers(0, 2**32, p, dtype=np.uint32)
    enable = rng.random(p) > 0.2
    enable[:64] = False
    return tab, surf, seeds, enable


CASES = [1, 2, 600, cr.RIS_SMEM_LIGHTS + 1]


@pytest.mark.parametrize("k", [16, 7])
@pytest.mark.parametrize("n_lights", CASES)
def test_records_audition_is_plain_bit_for_bit(n_lights, k):
    tab, surf, seeds, enable = _case(n_lights, 2048, n_lights + k)
    table = cr.LightTable(*(t(x) for x in tab))
    args = (t(seeds.astype(np.int64)), *(t(x) for x in surf), k, t(enable))
    rec = light_records(table)
    assert rec.shape == (n_lights, 4, 4)
    ps, pres = cr.ris_audition_plain(table, *args)
    ms, mres = audition_from_records(rec, *args)
    assert torch.equal(ms, ps)
    for key in FIELDS:
        assert torch.equal(mres[key].view(torch.int32),
                           pres[key].view(torch.int32)), key
    # the disabled lanes keep an empty reservoir
    off = ~t(enable)
    assert (pres["M"][off] == 0).all() and (pres["W"][off] == 0).all()
    assert (pres["M"][~off] == k).all()


class _Lights:
    """The JAX Lights interface over a raw table (test_torch_restir.py's
    many-lights test)."""

    def __init__(self, tab):
        self.v0, self.v1, self.v2, self.emission = (jnp.asarray(x) for x in tab)
        self.num = tab[0].shape[0]

    def gather(self, idx):
        return jr.Lights.gather(self, idx)

    def eval_p_hat(self, *a):
        return jr.Lights.eval_p_hat(self, *a)


@pytest.mark.parametrize("n_lights", CASES)
def test_records_audition_matches_jax(n_lights):
    tab, surf, seeds, enable = _case(n_lights, 4096, 50 + n_lights)
    rec = light_records(cr.LightTable(*(t(x) for x in tab)))
    ms, mres = audition_from_records(rec, t(seeds.astype(np.int64)),
                                     *(t(x) for x in surf), 16, t(enable))
    if n_lights <= 512:
        js, jres = ris_audition_pallas(
            *(jnp.asarray(x) for x in tab), jnp.asarray(seeds),
            *(jnp.asarray(x) for x in surf), 16, jnp.asarray(enable))
    else:
        js, jres = jax.jit(lambda sd, *a: jr.ris_audition(
            _Lights(tab), sd, *a, 16, jnp.asarray(enable), kernel="jnp"))(
                seeds, *surf)
        jres = dataclasses.asdict(jres)
    check_reservoir(ms, mres, js, jres)
