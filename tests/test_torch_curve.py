"""fourier_tpu_torch.ops.curve against fourier_tpu.ops.curve, limb for limb.

The 160-lane plan of tests/test_pallas.py (a same-point lane, an inverse
pair, identities on either side and both) goes through the complete
formulas of both packages, the trees and the affine conversions.  The
JAX side runs as its own tests run it: the jnp path, and for each point
kernel one case through the Pallas interpreter (TILE patched to 128, two
grid steps with padding): the incomplete kernels behind the fast paths,
and the complete pallas_curve.madd/add (_madd_kernel, _add_kernel) against
K5's twin and K2.  Comparisons are exact.  The CUDA kernels against their
plain twins on a card are in test_torch_kernels.py.
"""

import random

import numpy as np
import pytest
import torch

from fourier_tpu.constants import R
from fourier_tpu.ops import curve as jcv
from fourier_tpu.ops import pallas_curve as pc
from fourier_tpu.ops.field import FP as JFP
from fourier_tpu.refimpl.curve import G1_GEN, g1_add, g1_mul, g1_neg
from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import kernels

torch.set_num_threads(1)

N = 160
COLLIDE, INVERSE, P_INF, Q_INF, BOTH_INF = 10, 11, 12, 13, 14


@pytest.fixture(scope="module")
def lanes():
    rng = random.Random(0xC0FE)
    base = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(40)]
    ps = [rng.choice(base) for _ in range(N)]
    qs = [rng.choice(base) for _ in range(N)]
    qs[COLLIDE] = ps[COLLIDE]
    qs[INVERSE] = g1_neg(ps[INVERSE])
    ps[P_INF] = None
    qs[Q_INF] = None
    ps[BOTH_INF] = qs[BOTH_INF] = None
    return ps, qs


def _to_torch(p):
    """A JAX point batch as the port's (int64 limbs, bool infinity)."""
    cls = tcv.G1Aff if hasattr(p, "inf") else tcv.G1Jac
    arrs = [np.array(c) for c in p]
    return cls(*(torch.as_tensor(a if a.dtype == np.bool_ else a.astype(np.int64))
                 for a in arrs))


def _same(j, t):
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64))


def _operands(ps, qs):
    jp = jcv.from_affine(jcv.affine_from_ints(ps))
    jq_aff = jcv.affine_from_ints(qs)
    jq = jcv.from_affine(jq_aff)
    return jp, jq_aff, jq, _to_torch(jp), _to_torch(jq_aff), _to_torch(jq)


def test_point_formulas_match_jax(lanes):
    ps, qs = lanes
    jp, jq_aff, jq, tp, tq_aff, tq = _operands(ps, qs)
    expect = [g1_add(a, b) for a, b in zip(ps, qs)]
    _same(jcv.add(jp, jq), tcv.add(tp, tq))
    _same(jcv.madd(jp, jq_aff), tcv.madd(tp, tq_aff))
    _same(jcv.dbl(jp), tcv.dbl(tp))
    assert tcv.jac_to_int_points(tcv.add(tp, tq)) == expect
    assert tcv.jac_to_int_points(tcv.madd(tp, tq_aff)) == expect
    assert tcv.jac_to_int_points(tcv.dbl(tp)) == [g1_add(a, a) for a in ps]


@pytest.mark.parametrize("op", ["madd", "add", "dbl"])
def test_fast_paths_match_pallas_interpreter(lanes, op, monkeypatch):
    """curve.madd_fast/add_fast/dbl_fast through the Pallas kernels
    (_madd_inc_kernel, _add_inc_kernel with the collision rerun,
    _dbl_kernel) against the port's dispatchers on CPU tensors."""
    monkeypatch.setenv("FOURIER_PALLAS", "1")
    monkeypatch.setenv("FOURIER_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pc, "TILE", 128)
    ps, qs = lanes
    jp, jq_aff, jq, tp, tq_aff, tq = _operands(ps, qs)
    if op == "madd":
        _same(jcv.madd_fast(jp, jq_aff), tcv.madd_fast(tp, tq_aff))
    elif op == "add":
        _same(jcv.add_fast(jp, jq), tcv.add_fast(tp, tq))
    else:
        _same(jcv.dbl_fast(jp), tcv.dbl_fast(tp))
        _same(jcv.dbl_fast(jcv.dbl_fast(jcv.dbl_fast(jp))), tcv.dbl_fast(tp, repeat=3))


@pytest.mark.parametrize("op", ["madd", "add"])
def test_complete_pallas_kernels_match_k5_and_k2(lanes, op, monkeypatch):
    """pallas_curve.madd (_madd_kernel) against K5's plain twin and
    pallas_curve.add (_add_kernel) against K2's, on the lane plan: as
    points, and as limbs once the kernel's [0, 2p) values are reduced."""
    monkeypatch.setenv("FOURIER_PALLAS", "1")
    monkeypatch.setenv("FOURIER_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pc, "TILE", 128)
    ps, qs = lanes
    jp, jq_aff, jq, tp, tq_aff, tq = _operands(ps, qs)
    if op == "madd":
        jout = jcv.G1Jac(*pc.madd(jp.x, jp.y, jp.z, jq_aff.x, jq_aff.y, jq_aff.inf))
        tout = kernels.g1_madd(tp, tq_aff)
    else:
        jout = jcv.G1Jac(*pc.add(jp.x, jp.y, jp.z, jq.x, jq.y, jq.z))
        tout = kernels.g1_add(tp, tq)
    expect = [g1_add(a, b) for a, b in zip(ps, qs)]
    assert jcv.jac_to_int_points(jout) == expect
    assert tcv.jac_to_int_points(tout) == expect
    _same(jcv.G1Jac(*(JFP.canonicalize(c) for c in jout)), tout)


def test_trees_match_jax(lanes):
    ps, qs = lanes
    jp, _, jq, tp, _, tq = _operands(ps[:37], qs[:37])
    _same(jcv.tree_reduce_last(jp, to=4), tcv.tree_reduce_last(tp, to=4))
    grid_j = jcv.G1Jac(*(c[:, :36].reshape(c.shape[0], 12, 3) for c in jq))
    grid_t = tcv.G1Jac(*(c[:, :36].reshape(c.shape[0], 12, 3) for c in tq))
    _same(jcv.tree_reduce_axis(grid_j, -2), tcv.tree_reduce_axis(grid_t, -2))
    _same(jcv.tree_reduce_axis(grid_j, -1), tcv.tree_reduce_axis(grid_t, -1))
    small_j = jcv.G1Jac(*(c[:, :6] for c in jp))
    small_t = tcv.G1Jac(*(c[:, :6] for c in tp))
    _same(jcv.fold_small(small_j), tcv.fold_small(small_t))
    total = None
    for a in ps[:6]:
        total = g1_add(total, a)
    assert tcv.jac_to_int_points(tcv.fold_small(small_t)) == [total]


def test_affine_conversions_match_jax(lanes):
    ps, qs = lanes
    jp, jq_aff, _, tp, tq_aff, _ = _operands(ps[:70], qs[:70])
    _same(jq_aff, tq_aff)
    jsum, tsum = jcv.add(jp, jcv.from_affine(jq_aff)), tcv.add(tp, tcv.from_affine(tq_aff))
    _same(jcv.to_affine(jsum), tcv.to_affine(tsum))
    _same(jcv.to_affine_batched(jsum), tcv.to_affine_batched(tsum))
    assert tcv.jac_to_int_points(tsum) == jcv.jac_to_int_points(jsum)
