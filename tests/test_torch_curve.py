"""fourier_tpu_torch.ops.curve against fourier_tpu.ops.curve, limb for limb.

The 160-lane plan of tests/test_pallas.py (a same-point lane, an inverse
pair, identities on either side and both) goes through the complete
formulas of both packages, the trees and the affine conversions.  The
JAX side runs as its own tests run it: the jnp path, and for each point
kernel one case through the Pallas interpreter (TILE patched to 128, two
grid steps with padding): the incomplete kernels behind the fast paths,
and the complete pallas_curve.madd/add (_madd_kernel, _add_kernel) against
K5's twin and K2.  The redundant forms of the kernels' doubling and
additions (Python-int models of csrc/g1.cuh) stay in [0, 2p) and
canonicalise to the plain twins' limbs, and K5's ladder model equals its
twin.  Comparisons are exact.  The CUDA kernels against their
plain twins on a card are in test_torch_kernels.py.
"""

import os
import random
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fourier_tpu.constants import FP_LIMBS, R
from fourier_tpu.ops import curve as jcv
from fourier_tpu.ops import msm as jmsm
from fourier_tpu.ops import pallas_curve as pc
from fourier_tpu.ops.field import FP as JFP
from fourier_tpu.ops.limbs import ints_to_vec, vec_to_ints
from fourier_tpu.refimpl.curve import G1_GEN, g1_add, g1_mul, g1_neg
from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import kernels

import torch_redundant as rd

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
    grid_j = jcv.G1Jac(*(c[:, :36].reshape(c.shape[0], 12, 3) for c in jq))
    grid_t = tcv.G1Jac(*(c[:, :36].reshape(c.shape[0], 12, 3) for c in tq))
    small_j = jcv.G1Jac(*(c[:, :6] for c in jp))
    small_t = tcv.G1Jac(*(c[:, :6] for c in tp))
    refs = (lambda: jcv.tree_reduce_last(jp, to=4), lambda: jcv.tree_reduce_axis(grid_j, -2),
            lambda: jcv.tree_reduce_axis(grid_j, -1), lambda: jcv.fold_small(small_j))
    with ThreadPoolExecutor(len(refs)) as pool:   # the reference's four compiles at once
        want = [pool.submit(f) for f in refs]
        got = [tcv.tree_reduce_last(tp, to=4), tcv.tree_reduce_axis(grid_t, -2),
               tcv.tree_reduce_axis(grid_t, -1), tcv.tree_reduce_last(small_t, 1)]
        for j, t in zip(want, got):
            _same(j.result(), t)
    total = None
    for a in ps[:6]:
        total = g1_add(total, a)
    assert tcv.jac_to_int_points(tcv.tree_reduce_last(small_t, 1)) == [total]


@pytest.mark.parametrize("axis,to", [(-1, 1), (-1, 4), (-2, 1)])
def test_tree_kernel_twin_matches_jax(lanes, axis, to):
    """g1_tree_reduce's plain twin on a [24, 4, 13] batch (13 leaves pad
    to 16, the lane plan's identities inside) equals the reference's
    tree_reduce_last / tree_reduce_axis and the port's dispatchers."""
    ps, qs = lanes
    jp, _, _, tp, _, _ = _operands(ps[:52], qs[:52])
    jgrid = jcv.G1Jac(*(c.reshape(c.shape[0], 4, 13) for c in jp))
    tgrid = tcv.G1Jac(*(c.reshape(c.shape[0], 4, 13) for c in tp))
    got = kernels.g1_tree_reduce_plain(tgrid, axis, to)
    if axis == -1:
        want, dispatched = jcv.tree_reduce_last(jgrid, to=to), tcv.tree_reduce_last(tgrid, to)
    else:
        got = tcv.G1Jac(*(c.squeeze(axis) for c in got))
        want, dispatched = jcv.tree_reduce_axis(jgrid, axis), tcv.tree_reduce_axis(tgrid, axis)
    _same(want, got)
    _same(want, dispatched)


def test_tree_kernel_layout_reads_views():
    """The strides g1_tree_reduce hands its kernel address the leaves of
    sliced, broadcast and permuted views: as_strided over each
    coordinate's storage rebuilds the logical [24, groups0, groups1, n]."""
    base = torch.arange(24 * 5 * 3 * 7, dtype=torch.int64).reshape(24, 5, 3, 7)
    wide = torch.arange(24 * 2 * 3 * 4 * 5, dtype=torch.int64).reshape(24, 2, 3, 4, 5)
    cases = [
        (tcv.G1Jac(base, base, base.clone()), -1),
        (tcv.G1Jac(base[:, :, :1].expand(24, 5, 3, 7), base, base[:, 1:4].clone()[:, :1]
                   .expand(24, 5, 3, 7)), -1),
        (tcv.G1Jac(base[:, 1:4, :, ::2], base[:, :3, :, :4], base[:, 2:, :, 3:]), -2),
        (tcv.G1Jac(base, base, base), 1),
        (tcv.G1Jac(wide[:, :, :1].expand(24, 2, 3, 4, 5), wide, torch.cat([wide, wide], 3)[:, :, :, ::2]),
         -2),
        (tcv.G1Jac(wide[:, :, :, :1].expand(24, 2, 3, 4, 5), wide.transpose(1, 3)
                   .transpose(1, 3), wide.permute(0, 2, 1, 3, 4).contiguous()
                   .permute(0, 2, 1, 3, 4)), -1),
    ]
    for p, axis in cases:
        coords, g0, g1, strides = kernels._tree_layout(p, axis % p.x.ndim)
        n = p.x.shape[axis]
        for k, (c, view) in enumerate(zip(coords, p)):
            rebuilt = torch.as_strided(c, (24, g0, g1, n), strides[4 * k:4 * k + 4],
                                       c.storage_offset())
            assert torch.equal(rebuilt, view.movedim(axis, -1).reshape(24, g0, g1, n))


def _pair(a, b):
    """An addition that records its association; None is the identity."""
    return b if a is None else a if b is None else (a, b)


@pytest.mark.parametrize("n,to", [(13, 1), (37, 4), (256, 1), (300, 3), (384, 3), (1000, 3),
                                  (1500, 32), (2100, 1), (1024, 32)])
def test_tree_kernel_plan_pairs_like_the_reference(n, to):
    """The lanes and fan-in levels that g1_tree_reduce hands its kernel,
    run through the kernel's loops (csrc/g1_tree.cu: the fan-in while
    loading, a binary counter over m bit-reversed, then the halving levels
    over the shared lanes) with an addition that records its association,
    give the roots of the reference's halving tree, bracket for bracket."""
    lanes, fan = kernels.tree_plan(n, to)
    assert lanes % to == 0 and (lanes // to) & (lanes // to - 1) == 0
    assert lanes <= kernels.TREE_LANES and fan <= kernels.TREE_MAX_FAN_LEVELS
    width = to << (-(-n // to) - 1).bit_length()
    assert lanes << fan == width

    def leaf(j):
        return j if j < n else None

    ref = [leaf(j) for j in range(width)]
    while len(ref) > to:
        half = len(ref) // 2
        ref = [_pair(ref[i], ref[i + half]) for i in range(half)]
    shared = []
    for i in range(lanes):
        stack, v = [None] * fan, None
        for t in range(1 << fan):
            m = int(format(t, f"0{fan}b")[::-1], 2) if fan else 0
            v = leaf(i + m * lanes)
            lvl = 0
            while (t >> lvl) & 1:
                v = _pair(stack[lvl], v)
                lvl += 1
            if t + 1 < 1 << fan:
                stack[lvl] = v
        shared.append(v)
    while len(shared) > to:
        half = len(shared) // 2
        shared = [_pair(shared[i], shared[i + half]) for i in range(half)]
    assert shared == ref


def test_tree_kernel_limits_match_its_source():
    """The limits kernels.py checks before a launch are the ones compiled
    into csrc/g1_tree.cu, and a plan past them is refused on the host."""
    with open(os.path.join(kernels.CSRC, "g1_tree.cu")) as fh:
        src = fh.read()
    for name in ("TREE_MAX_FAN_LEVELS", "TREE_MAX_TREES"):
        assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == getattr(kernels, name)
    assert kernels.TREE_THREADS <= int(re.search(r"#define TREE_MAX_THREADS (\d+)", src).group(1))
    with pytest.raises(ValueError):
        kernels.tree_plan((kernels.TREE_LANES << kernels.TREE_MAX_FAN_LEVELS) + 1, 1)
    with pytest.raises(ValueError):
        kernels.tree_plan(1000, kernels.TREE_LANES + 1)


def test_horner_limits_match_its_source():
    """K4's lane limit in kernels.py is the one compiled into
    csrc/horner_2k.cu, and its plan refuses what the kernel cannot take."""
    with open(os.path.join(kernels.CSRC, "horner_2k.cu")) as fh:
        src = fh.read()
    assert int(re.search(r"#define H4_LANES (\d+)", src).group(1)) == kernels.H4_LANES
    assert kernels.horner_plan(16, 64) == (64, 4, 4)
    assert kernels.horner_plan(260, 32) == (32, 8, 33)
    assert kernels.horner_plan(6, 37) == (64, 4, 2)
    with pytest.raises(ValueError):
        kernels.horner_plan(4, kernels.H4_LANES + 1)
    with pytest.raises(ValueError):
        kernels.horner_plan(kernels.H4_LANES * 8 + 1, 32)


def _dbl_lanes(rng):
    """Montgomery (x, y, z) ints for K3: coordinates 0, 1 and p - 1,
    identities (z = 0, with x and y zero or not), and the lanes of 3000
    random ones whose redundant doubling carries (x3, y3, z3) closest to
    2p, or holds any value closest to 2p."""
    p = JFP.modulus
    lanes = [(0, 0, 0), (rng.randrange(p), rng.randrange(p), 0), (p - 1, 1, 0),
             (0, rng.randrange(p), rng.randrange(p)), (rng.randrange(p), 0, rng.randrange(p)),
             (1, 1, 1), (p - 1, p - 1, p - 1), (1, p - 1, p - 1), (p - 1, 0, 1)]
    cands = [tuple(rng.randrange(p) for _ in range(3)) for _ in range(3000)]
    vals = [rd.g1_dbl_redundant(*c) for c in cands]
    carried = sorted(range(len(cands)), key=lambda i: 2 * p - max(vals[i][-3:]))
    held = sorted(range(len(cands)), key=lambda i: 2 * p - max(vals[i]))
    return lanes + [cands[i] for i in carried[:4] + held[:3]]


@pytest.mark.parametrize("repeat", [1, 3, 16])
def test_redundant_doubling_matches_jax_dbl_n(repeat):
    """K3's chain in its redundant form (torch_redundant.g1_dbl_redundant, the
    values csrc/g1.cuh holds) stays in [0, 2p) and, made canonical, gives
    the limbs of K3's plain twin, which equal the reference's _dbl_n limb
    for limb; on coordinates 0, 1, p - 1, identities, and lanes whose
    values come near 2p after one step."""
    p = JFP.modulus
    lanes = _dbl_lanes(random.Random(0xD8))
    state = list(lanes)
    for _ in range(repeat):
        held = [rd.g1_dbl_redundant(*s) for s in state]
        assert all(0 <= v < 2 * p for vs in held for v in vs)
        state = [tuple(vs[-3:]) for vs in held]
    canon = [[v - p if v >= p else v for v in s] for s in state]
    coords = [ints_to_vec([ln[k] for ln in lanes], FP_LIMBS) for k in range(3)]
    jp = jcv.G1Jac(*(np.asarray(c, dtype=np.uint32) for c in coords))
    tp = tcv.G1Jac(*(torch.as_tensor(c.astype(np.int64)) for c in coords))
    got = kernels.g1_dbl(tp, repeat)
    for _ in range(repeat):          # one compile of the reference's _dbl_n for every case
        jp = jmsm._dbl_n(jp, 1)
    _same(jp, got)
    for k in range(3):
        assert vec_to_ints(got[k].numpy()) == [s[k] for s in canon]


@pytest.mark.parametrize("op,repeat", [("add", 1), ("add", 3), ("madd", 1), ("madd", 3)])
def test_redundant_additions_match_twins(op, repeat):
    """The complete additions in their redundant form (torch_redundant.
    g1_add_redundant, g1_madd_redundant: the values csrc/g1.cuh holds)
    stay in [0, 2p) and, made canonical, give the limbs of K2's and K5's
    plain twins (held against the reference limb for limb above), on the
    edge lanes of torch_redundant.addition_edge_lanes (identities, P = Q, P = -Q,
    0, 1, p - 1, values near 2p); repeat > 1 adds Q again to the redundant sum,
    so the redundant inputs of a chain (the ladder's) are covered too."""
    p = JFP.modulus
    pairs = rd.addition_edge_lanes(random.Random(0xADD + repeat), op == "madd")
    state = [a for a, _ in pairs]
    for _ in range(repeat):
        if op == "madd":
            held = [rd.g1_madd_redundant(a, *b) for a, (_, b) in zip(state, pairs)]
        else:
            held = [rd.g1_add_redundant(a, b) for a, (_, b) in zip(state, pairs)]
        assert all(0 <= v < 2 * p for vs in held for v in vs)
        state = [tuple(vs[-3:]) for vs in held]

    def limbs(vals):
        return torch.as_tensor(ints_to_vec(list(vals), FP_LIMBS).astype(np.int64))

    twin = tcv.G1Jac(*(limbs(a[k] for a, _ in pairs) for k in range(3)))
    for _ in range(repeat):
        if op == "madd":
            q = tcv.G1Aff(limbs(b[0] for _, b in pairs), limbs(b[1] for _, b in pairs),
                          torch.zeros(len(pairs), dtype=torch.bool))
            twin = kernels.g1_madd_plain(twin, q)
        else:
            twin = kernels.g1_add_plain(twin, tcv.G1Jac(*(limbs(b[k] for _, b in pairs)
                                                          for k in range(3))))
    for k in range(3):
        assert vec_to_ints(twin[k].numpy()) == [s[k] % p for s in state]


@pytest.mark.parametrize("nbits", [0, 1, 255])
def test_redundant_ladder_matches_its_twin(nbits):
    """K5's ladder modelled in its redundant form (g1_dbl_redundant and
    g1_madd_redundant a bit, canonical once at the end) stays in [0, 2p)
    and equals its plain twin, the stepwise canonical chain, limb for limb;
    on 8 curve points with one at infinity and scalars 0, 1, r - 1, r + 2
    (the sum meets the point: the doubling branch) and random ones."""
    p = JFP.modulus
    rng = random.Random(0x1ADD)
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(8)]
    pts[5] = None
    sc = [0, 1, R - 1, R + 2] + [rng.randrange(R) for _ in range(4)]
    aff = tcv.affine_from_ints(pts)
    xs, ys = (vec_to_ints(c.numpy()) for c in aff[:2])
    out = []
    for x, y, pt, s in zip(xs, ys, pts, sc):
        acc = (0, 0, 0)
        for k, b in enumerate(reversed(range(nbits))):
            if k:
                held = rd.g1_dbl_redundant(*acc)
                assert all(0 <= v < 2 * p for v in held)
                acc = tuple(held[-3:])
            if pt is not None and (s >> b) & 1:
                held = rd.g1_madd_redundant(acc, x, y)
                assert all(0 <= v < 2 * p for v in held)
                acc = tuple(held[-3:])
        out.append([v % p for v in acc])
    tsc = torch.as_tensor(ints_to_vec(sc, 16).astype(np.int64))
    got = kernels.g1_madd_ladder(aff, tsc, nbits)
    assert [list(c) for c in zip(*(vec_to_ints(g.numpy()) for g in got))] == out
    assert tcv.jac_to_int_points(got) == [
        g1_mul(pt, s % (1 << nbits)) if pt is not None else None for pt, s in zip(pts, sc)]


def test_affine_conversions_match_jax(lanes):
    ps, qs = lanes
    jp, jq_aff, _, tp, tq_aff, _ = _operands(ps[:70], qs[:70])
    _same(jq_aff, tq_aff)
    jsum, tsum = jcv.add(jp, jcv.from_affine(jq_aff)), tcv.add(tp, tcv.from_affine(tq_aff))
    _same(jcv.to_affine(jsum), tcv.to_affine(tsum))
    _same(jcv.to_affine_batched(jsum), tcv.to_affine_batched(tsum))
    assert tcv.jac_to_int_points(tsum) == jcv.jac_to_int_points(jsum)
