"""PyTorch port, the backward of parallel/halo.exchange_rows on 8 gloo
ranks (tests/torch_dist.py): the adjoint identity <exchange(x), y> =
<x, exchange^T(y)> summed over the ranks, float64, for edge="zero" and
edge="edge" with a 10-row halo over 4-row bands (three hops each way)
and exchange_flat_many of a float and an int32 field (only the float
columns' cotangents move: the backward tally counts them alone); the
same bits on two runs; a backward exchange met by another exchange's
cotangent raising on both ranks, not hanging; and an exchange inside a
backward pass (a checkpoint's recompute) raising."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread in this process)
from torch_dist import halo_grads, run_ranks

RANKS = 8
H, W, HL, HALO = 32, 5, 4, 10


@pytest.fixture(scope="module")
def port():
    return run_ranks(RANKS, halo_grads, dict(h=H, w=W, hl=HL, halo=HALO))


@pytest.mark.parametrize("edge,rtol", [("zero", 1e-12), ("edge", 1e-12),
                                       ("flat_many", 1e-6)])
def test_adjoint_identity(port, edge, rtol):
    """float64 to 1e-12; the flat fields are float32, their cotangent
    sums rounded to float32."""
    lhs = sum(r[edge]["lhs"] for r in port)
    rhs = sum(r[edge]["rhs"] for r in port)
    assert abs(lhs) > 1.0
    assert abs(lhs - rhs) <= rtol * abs(lhs)


@pytest.mark.parametrize("edge", ["zero", "edge", "flat_many"])
def test_two_runs_same_bits(port, edge):
    for r in port:
        assert r[edge]["grad"].tobytes() == r[edge]["grad2"].tobytes()


def test_backward_tally(port):
    """Three hops each way, every rank counting all of them (the JAX
    tally's count); exchange_flat_many's backward moves the float
    field's 3 columns of its 4."""
    for r in port:
        t = r["edge"]["tally"]
        assert t["grad_calls"] == t["calls"] == 6
        assert t["grad_bytes"] == t["bytes"]
        f = r["flat_many"]["tally"]
        assert f["grad_bytes"] * 4 == f["bytes"] * 3
    assert port[0]["edge"]["tally"]["grad_sends"] == 3   # no rank above


def test_int32_field_carries_no_gradient(port):
    for r in port:
        assert r["flat_many"]["int_exact"]


def test_out_of_order_backward_raises(port):
    for r in port[:2]:
        assert "different orders" in r["mismatch"]


def test_exchange_in_a_backward_pass_raises():
    from torch.utils.checkpoint import checkpoint

    from sunray_tpu_torch.parallel.halo import ShardGrid, exchange_rows

    grid = ShardGrid(None, 1, 0, 0, 4, 3, 4, 2, 2)
    x = torch.ones(4, 3, requires_grad=True)
    y = checkpoint(lambda a: (exchange_rows(a * 2.0, 2, 2, grid) ** 2).sum(),
                   x, use_reentrant=False)
    with pytest.raises(RuntimeError, match="inside a backward pass"):
        y.backward()
