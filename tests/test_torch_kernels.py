"""The CUDA kernels of fourier_tpu_torch against their plain twins, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports no jax (tests/conftest.py does), so it runs where only the port
is installed:

    python -m pytest --noconftest -o addopts= -m cuda tests/test_torch_kernels.py

The 160-lane plan of tests/test_pallas.py (a same-point lane, an inverse
pair, identities on either side and both) goes through each point kernel,
K5 on it again with q affine (its plain twin, refimpl and the doubling
count), a BGMW MSM with an infinity row, a zero scalar and a duplicated
point with an equal scalar through K1, K2 and K4, and the tableless MSMs
(msm through K1, the tree kernel and K4; msm_naive through K5's ladder
and K2),
K1 on runs that span several pieces, the tree kernel on groups whose
halves meet the same point, its inverse or an identity, at widths below
and past the lanes a block keeps, K3 on coordinates 0, 1, p - 1,
identities and lanes whose redundant values come near 2p, K2 and K5 on
such lanes too (identities, P = Q, P = -Q), K5's ladder at 8 and 64
lanes and 0, 1 and 255 bits, and K4 at the main path's shapes and on
all-identity terms, one finite lane and equal terms.  The round as one
call (parallel/prove_sharded.py) runs on the card and on the CPU from one
setup, tabled and tableless, at M = 4 rows of 16 points (msm_naive's
ladder) and M = 1 row of 128 (the tableless msm), with equal outputs.
The open's quotient (fr_quotient, four launches a call) equals its plain
twin run on the card in y, q and the flag: one row at T = 2^19, four rows
at 2^18 (prove_sharded's batch), T = 2^4 and 2^8, alpha on the domain,
alpha 0, rows of zeros and lanes at r - 1; a workerOpen at a domain point
takes the coefficient-basis fallback and answers as the CPU backend of the
same secrets does.
Every wrapper launches on cuda:1 from a thread whose current device is
cuda:0 (two cards or more), four threads launching at once keep the
launch count exact, and the BGMW MSM over the in-process shards of
parallel/mesh.py (four of one card, and every card) equals one card's.
Comparisons are exact.
"""

import random

import pytest
import torch

from fourier_tpu_torch.constants import FR_LIMBS, R
from fourier_tpu_torch.utils.trace import TRACER
from fourier_tpu_torch.ops.limbs import ints_to_vec
from fourier_tpu_torch.refimpl.curve import G1_GEN, g1_add, g1_msm, g1_mul, g1_neg
from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import kernels
from fourier_tpu_torch.ops.field import FP
from fourier_tpu_torch.ops import msm as tmsm
from fourier_tpu_torch.ops import msm_fused as tmf

import torch_redundant as rd

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    return torch.device("cuda")


def _to(p, device):
    return type(p)(*(c.to(device) for c in p))


def _lanes(n=160):
    rng = random.Random(0xC0FE)
    base = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(40)]
    ps = [rng.choice(base) for _ in range(n)]
    qs = [rng.choice(base) for _ in range(n)]
    qs[10] = ps[10]          # same point: the doubling branch
    qs[11] = g1_neg(ps[11])  # inverse pair
    ps[12] = None            # identity on the left, the right, both
    qs[13] = None
    ps[14] = qs[14] = None
    return ps, qs


@pytest.mark.cuda
def test_point_kernels_match_plain_twins(cuda_device):
    ps, qs = _lanes()
    tp = tcv.from_affine(tcv.affine_from_ints(ps))
    tq_aff = tcv.affine_from_ints(qs)
    tq = tcv.from_affine(tq_aff)
    p, q, q_aff = _to(tp, cuda_device), _to(tq, cuda_device), _to(tq_aff, cuda_device)
    added = kernels.g1_add(p, q)
    for got, want in [
        (added, kernels.g1_add_plain(tp, tq)),
        (kernels.g1_dbl(p, 3), kernels.g1_dbl_plain(tp, 3)),
        (kernels.g1_madd(p, q_aff), kernels.g1_madd_plain(tp, tq_aff)),
        (kernels.horner_2k(q, 32), kernels.horner_2k_plain(tq, 32)),
    ]:
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    assert tcv.jac_to_int_points(added) == [g1_add(a, b) for a, b in zip(ps, qs)]


@pytest.mark.cuda
def test_bgmw_msm_on_card_matches_cpu(cuda_device):
    rng = random.Random(0x3535)
    n, c = 32, 7
    points = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    points[5] = None         # infinity row
    points[9] = points[8]    # duplicated point, with an equal scalar below
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[3] = 0
    scalars[9] = scalars[8]
    table = tmsm.bgmw_expand(tcv.affine_from_ints(points), c)
    packed = tmf.pack_points(table)
    sc = torch.as_tensor(ints_to_vec(scalars, FR_LIMBS).astype("int64"))
    cpu = tmf.msm_fused_bgmw(packed, table.inf, sc, c)
    card = tmf.msm_fused_bgmw(packed.to(cuda_device), table.inf.to(cuda_device),
                              sc.to(cuda_device), c)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    got = tcv.jac_to_int_points(tcv.G1Jac(*(x[..., None] for x in card)))[0]
    assert got == g1_msm(points, scalars)


@pytest.mark.cuda
def test_g1_madd_on_card_matches_twin_and_refimpl(cuda_device):
    ps, qs = _lanes()
    tp = tcv.from_affine(tcv.affine_from_ints(ps))
    tq_aff = tcv.affine_from_ints(qs)
    before = kernels.COUNTERS.collisions()["g1_madd"]
    got = kernels.g1_madd(_to(tp, cuda_device), _to(tq_aff, cuda_device))
    for a, b in zip(got, kernels.g1_madd_plain(tp, tq_aff)):
        assert torch.equal(a.cpu(), b)
    assert tcv.jac_to_int_points(got) == [g1_add(a, b) for a, b in zip(ps, qs)]
    same = sum(1 for a, b in zip(ps, qs) if a is not None and a == b)   # lane 10, and chance
    assert kernels.COUNTERS.collisions()["g1_madd"] - before == same


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 80])
def test_tableless_msm_on_card_matches_cpu(cuda_device, n):
    rng = random.Random(n)
    points = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    points[3] = None
    scalars = [rng.randrange(R) for _ in range(n)]
    aff = tcv.affine_from_ints(points)
    sc = torch.as_tensor(ints_to_vec(scalars, FR_LIMBS).astype("int64"))
    fn = tmsm.msm_naive if n <= 64 else tmsm.msm
    cpu = fn(aff, sc)
    card = fn(_to(aff, cuda_device), sc.to(cuda_device))
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    assert tcv.jac_to_int_points(tcv.G1Jac(*(x[..., None] for x in card)))[0] \
        == g1_msm(points, scalars)


@pytest.mark.cuda
def test_accumulate_pieces_match_plain_twin(cuda_device):
    """K1 on runs of up to 3 x PIECE rows against its twin at piece=PIECE,
    limb for limb, and against whole runs as group elements: a row
    repeated (doubling inside a piece, and two equal piece sums), a row
    and its negation (the identity mid-run), two opposite piece sums,
    identity rows, and empty runs."""
    rng = random.Random(0xACC)
    P = kernels.PIECE
    base = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(12)]
    table_pts = [rng.choice(base) for _ in range(64)]
    table_pts[3] = None
    runs = [[(rng.randrange(64) << 2) | (rng.randrange(2) << 1)
             for _ in range(rng.choice([0, 1, 2, P - 1, P, P + 1, 2 * P + 3, 3 * P]))]
            for _ in range(150)]
    runs[5] = [7 << 2] * (2 * P)
    runs[6] = [5 << 2, (5 << 2) | 2] * P
    runs[7] = [3 << 2] * (P + 5)
    runs[8] = [9 << 2] * P + [(9 << 2) | 2] * P
    entries, start, count = [], [], []
    for run in runs:
        start.append(len(entries))
        count.append(len(run))
        entries += [e | int(table_pts[e >> 2] is None) for e in run]
    table = tmf.pack_points(tcv.affine_from_ints(table_pts))
    index, start, count = (torch.tensor(v, dtype=torch.int32) for v in (entries, start, count))
    got = kernels.accumulate(table.to(cuda_device), index.to(cuda_device),
                             start.to(cuda_device), count.to(cuda_device))
    for a, b in zip(got, kernels.accumulate_plain(table, index, start, count, piece=P)):
        assert torch.equal(a.cpu(), b)
    assert tcv.jac_to_int_points(got) == tcv.jac_to_int_points(
        kernels.accumulate_plain(table, index, start, count))


@pytest.mark.cuda
@pytest.mark.parametrize("groups,n,axis,to", [(4, 13, -1, 1), (4, 37, -1, 4), (5, 16, -2, 1),
                                              (3, 1500, -1, 32), (2, 2100, -1, 1),
                                              (2, 300, -1, 3), (2, 1000, -1, 3)])
def test_tree_reduce_matches_plain_twin(cuda_device, groups, n, axis, to):
    """g1_tree_reduce against its plain twin, limb for limb, on groups
    whose first level pairs a point with itself, with its inverse, and
    identities on either side; widths past TREE_LANES fold while
    loading, also where `to` is not a power of two.  The roots are the refimpl sums of their leaves."""
    rng = random.Random(n)
    base = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(16)]
    half = (to << (-(-n // to) - 1).bit_length()) // 2
    leaves = []
    for _ in range(groups):
        row = [rng.choice(base) for _ in range(n)]
        for i, j in ((0, half), (1, half + 1)):
            if j < n:
                row[j] = row[i] if i == 0 else g1_neg(row[i])
        row[2] = None
        if half + 3 < n:
            row[half + 3] = None
        leaves.append(row)
    pts = tcv.from_affine(tcv.affine_from_ints([pt for row in leaves for pt in row]))
    if axis == -1:
        grid = tcv.G1Jac(*(c.reshape(24, groups, n) for c in pts))
    else:
        grid = tcv.G1Jac(*(c.reshape(24, groups, n).transpose(1, 2) for c in pts))
    got = kernels.g1_tree_reduce([(_to(grid, cuda_device), axis, to)])[0]
    want = kernels.g1_tree_reduce_plain(grid, axis, to)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    roots = tcv.G1Jac(*(c.movedim(axis, -1).reshape(24, -1) for c in got))
    sums = []
    for row in leaves:
        for r in range(min(to, n)):
            total = None
            for pt in row[r::to] if to < n else [row[r]]:
                total = g1_add(total, pt)
            sums.append(total)
    assert tcv.jac_to_int_points(roots) == sums


def _dbl_lanes(rng):
    """Montgomery (x, y, z) ints: coordinates 0, 1 and p - 1, identities,
    and of 3000 random lanes those whose redundant doubling carries values
    nearest 2p to the next step, or holds any value nearest 2p."""
    p = FP.modulus
    lanes = [(0, 0, 0), (rng.randrange(p), rng.randrange(p), 0), (p - 1, 1, 0), (1, 1, 1),
             (p - 1, p - 1, p - 1), (0, rng.randrange(p), 1), (1, p - 1, p - 1),
             (rng.randrange(p), 0, rng.randrange(p))]
    cands = [tuple(rng.randrange(p) for _ in range(3)) for _ in range(3000)]
    vals = [rd.g1_dbl_redundant(*c) for c in cands]
    carried = sorted(range(len(cands)), key=lambda i: 2 * p - max(vals[i][-3:]))
    held = sorted(range(len(cands)), key=lambda i: 2 * p - max(vals[i]))
    return lanes + [cands[i] for i in carried[:6] + held[:4]]


@pytest.mark.cuda
@pytest.mark.parametrize("repeat", [1, 3, 16])
def test_g1_dbl_edge_lanes_match_plain_twin(cuda_device, repeat):
    """K3's redundant chain against its canonical twin, limb for limb."""
    lanes = _dbl_lanes(random.Random(0xD8))
    tp = tcv.G1Jac(*(torch.as_tensor(ints_to_vec([ln[k] for ln in lanes], 24).astype("int64"))
                     for k in range(3)))
    got = kernels.g1_dbl(_to(tp, cuda_device), repeat)
    for a, b in zip(got, kernels.g1_dbl_plain(tp, repeat)):
        assert torch.equal(a.cpu(), b)


def _limbs(vals):
    return torch.as_tensor(ints_to_vec(list(vals), 24).astype("int64"))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "madd"])
def test_additions_on_edge_lanes_match_twins(cuda_device, op):
    """K2 and K5 (redundant complete additions, canonical at the store)
    against their canonical twins limb for limb on the edge lanes of
    torch_redundant.addition_edge_lanes, with the same-point lanes counted; then on the 160-lane
    curve plan against refimpl, with its doubling lanes counted."""
    pairs = rd.addition_edge_lanes(random.Random(0xADD), op == "madd")
    tp = tcv.G1Jac(*(_limbs(a[k] for a, _ in pairs) for k in range(3)))
    if op == "madd":
        tq = tcv.G1Aff(_limbs(b[0] for _, b in pairs), _limbs(b[1] for _, b in pairs),
                       torch.zeros(len(pairs), dtype=torch.bool))
        same = sum(1 for a, b in pairs if a[2] and rd.affine_ints(a) == b)
        run, plain = kernels.g1_madd, kernels.g1_madd_plain
    else:
        tq = tcv.G1Jac(*(_limbs(b[k] for _, b in pairs) for k in range(3)))
        same = sum(1 for a, b in pairs
                   if a[2] and b[2] and rd.affine_ints(a) == rd.affine_ints(b))
        run, plain = kernels.g1_add, kernels.g1_add_plain
    name = "g1_" + op
    before = kernels.COUNTERS.collisions()[name]
    got = run(_to(tp, cuda_device), _to(tq, cuda_device))
    for a, b in zip(got, plain(tp, tq)):
        assert torch.equal(a.cpu(), b)
    assert kernels.COUNTERS.collisions()[name] - before == same >= 2

    ps, qs = _lanes()
    tp = tcv.from_affine(tcv.affine_from_ints(ps))
    tq = tcv.affine_from_ints(qs)
    if op == "add":
        tq = tcv.from_affine(tq)
    before = kernels.COUNTERS.collisions()[name]
    got = run(_to(tp, cuda_device), _to(tq, cuda_device))
    for a, b in zip(got, plain(tp, tq)):
        assert torch.equal(a.cpu(), b)
    assert tcv.jac_to_int_points(got) == [g1_add(a, b) for a, b in zip(ps, qs)]
    assert kernels.COUNTERS.collisions()[name] - before == sum(
        1 for a, b in zip(ps, qs) if a is not None and a == b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("nbits", [0, 1, 255])
def test_ladder_on_card_matches_twin(cuda_device, n, nbits):
    """K5's ladder (msm_naive's double-and-add in one launch) against its
    plain twin, the stepwise canonical chain, limb for limb, and against
    refimpl: curve points with one at infinity, scalars 0, 1, r - 1, r + 2
    (the sum meets the point before the last bit: the doubling branch,
    counted) and random ones."""
    rng = random.Random(n * 1000 + nbits)
    pts = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    pts[5] = None
    sc = [0, 1, R - 1, R + 2, R + 2] + [rng.randrange(R) for _ in range(n - 5)]
    aff = tcv.affine_from_ints(pts)
    tsc = torch.as_tensor(ints_to_vec(sc, FR_LIMBS).astype("int64"))
    before = kernels.COUNTERS.collisions()["g1_madd"]
    got = kernels.g1_madd_ladder(_to(aff, cuda_device), tsc.to(cuda_device), nbits)
    for a, b in zip(got, kernels.g1_madd_ladder_plain(aff, tsc, nbits)):
        assert torch.equal(a.cpu(), b)
    mask = (1 << nbits) - 1
    assert tcv.jac_to_int_points(got) == [g1_mul(pt, s & mask) if pt is not None else None
                                          for pt, s in zip(pts, sc)]
    assert kernels.COUNTERS.collisions()["g1_madd"] - before == (2 if nbits == 255 else 0)


def _rand_coords(n, gen):
    x = torch.randint(0, 1 << 16, (24, n), generator=gen, dtype=torch.int64)
    x[23] = torch.randint(0, 0x1A01, (n,), generator=gen, dtype=torch.int64)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("K,width", [(16, 64), (260, 32)])
def test_horner_main_path_shapes_match_plain_twin(cuda_device, K, width):
    """K4 at the BGMW reduction's shape (one block a 4 terms) and the
    tableless MSM's (33 blocks, the last one short), on random
    coordinates, against its twin limb for limb."""
    gen = torch.Generator().manual_seed(K)
    terms = tcv.G1Jac(*(_rand_coords(K * width, gen) for _ in range(3)))
    got = kernels.horner_2k(_to(terms, cuda_device), width)
    for a, b in zip(got, kernels.horner_2k_plain(terms, width)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all identity", "one finite lane", "equal terms"])
def test_horner_edge_terms_match_plain_twin(cuda_device, kind):
    """K4 on all-identity terms, one finite lane among identities, and
    equal terms (same-point adds in the fold and the tree), across two
    blocks: against its twin limb for limb and refimpl as a point."""
    K, width = 6, 40
    P = g1_mul(G1_GEN, 0xC0FFEE)
    pts = [None] * (K * width)
    if kind == "one finite lane":
        pts[5 * width + 7] = P
    elif kind == "equal terms":
        pts = [P] * (K * width)
    expect = None
    for k in range(K):
        for pt in pts[k * width:(k + 1) * width]:
            if pt is not None:
                expect = g1_add(expect, g1_mul(pt, 1 << k))
    terms = tcv.from_affine(tcv.affine_from_ints(pts))
    before = kernels.COUNTERS.collisions()["horner_2k"]
    got = kernels.horner_2k(_to(terms, cuda_device), width)
    for a, b in zip(got, kernels.horner_2k_plain(terms, width)):
        assert torch.equal(a.cpu(), b)
    assert tcv.jac_to_int_points(got) == [expect]
    doubled = kernels.COUNTERS.collisions()["horner_2k"] - before
    assert (doubled > 0) == (kind == "equal terms")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(6, 2), (7, 0)])
def test_round_on_card_matches_cpu(cuda_device, n, m):
    from fourier_tpu_torch.convert import prove_outputs_to_ints
    from fourier_tpu_torch.models import piano as tpiano
    from fourier_tpu_torch.parallel import prove_sharded as ps

    rng = random.Random(0x9D + n)
    outs = {}
    for dev in ("cpu", cuda_device):
        fft = tpiano.PianoFFTSettings(n, m, dev)
        settings = tpiano.generate_trusted_setup(fft, (b"\x2a" * 32, b"\x2b" * 32))
        settings.precompute = tpiano.PianoPrecompute.generate(settings)
        b = tpiano.PianoBackend(fft, settings)
        if dev == "cpu":
            rows = [[rng.randrange(R) for _ in range(fft.T)] for _ in range(fft.M)]
            alpha, beta = rng.randrange(R), rng.randrange(R)
        for table_c in (settings.precompute.c, None):
            out = ps.build_distributed_prove(None, table_c)(
                *ps.prove_inputs_from_backend(b, rows, alpha, beta, table_c))
            outs[str(dev), table_c] = prove_outputs_to_ints(out)
    assert len(set(map(repr, outs.values()))) == 1
    got = outs["cpu", None]
    assert b.master_verify(got["master_com"], beta, alpha, got["z"], (got["pi0"], got["pi1"]))



QUOTIENT_KERNELS = ("fr_quotient_inv", "fr_quotient_sum", "fr_quotient_eval",
                    "fr_quotient_qhat")
R_MINUS_1 = torch.as_tensor(ints_to_vec([R - 1], FR_LIMBS).astype("int64"))


def _fr_rand(shape, gen):
    """Canonical random Fr limbs [16, *shape] (top limb below r's)."""
    x = torch.randint(0, 1 << 16, (FR_LIMBS,) + shape, generator=gen, dtype=torch.int64)
    x[FR_LIMBS - 1] = torch.randint(0, 0x73ED, shape, generator=gen, dtype=torch.int64)
    return x


def _quotient_case(kind, log_t, batch, dev):
    """(roots, f, alpha, t_inv) of random canonical values on dev."""
    gen = torch.Generator().manual_seed(log_t * 31 + len(batch))
    T = 1 << log_t
    roots, f = _fr_rand((T,), gen), _fr_rand(batch + (T,), gen)
    alpha, t_inv = _fr_rand((1,), gen), _fr_rand((1,), gen)
    if kind == "alpha on the domain":
        alpha = roots[:, T // 3:T // 3 + 1].clone()
    elif kind == "alpha 0":
        alpha.zero_()
    elif kind == "f zeros":
        f.zero_()
    elif kind == "f at r - 1":
        f[..., ::2] = R_MINUS_1.view((FR_LIMBS,) + (1,) * (f.ndim - 1))
    return [t.to(dev) for t in (roots, f, alpha, t_inv)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,log_t,batch", [
    ("random", 19, ()), ("random", 18, (4,)), ("random", 4, ()), ("random", 8, ()),
    ("alpha on the domain", 8, ()), ("alpha on the domain", 18, (4,)), ("alpha 0", 8, ()),
    ("f zeros", 8, (2,)), ("f at r - 1", 8, ()), ("f at r - 1", 4, (2, 3)),
])
def test_fr_quotient_matches_plain_twin(cuda_device, kind, log_t, batch):
    """y, q and the flag of the four launches equal the plain twin's on the
    card; one launch of each kernel a call, and no other."""
    args = _quotient_case(kind, log_t, batch, cuda_device)
    before = dict(kernels.COUNTERS.launches)
    got = kernels.fr_quotient(*args)
    launched = {k: v - before[k] for k, v in kernels.COUNTERS.launches.items() if v > before[k]}
    want = kernels.fr_quotient_plain(*args)
    assert launched == dict.fromkeys(QUOTIENT_KERNELS, 1)
    assert got[2] is want[2] is (kind == "alpha on the domain")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_open_at_a_domain_point_takes_the_fallback(cuda_device):
    """A workerOpen at alpha = w^3 sets the quotient's flag on the card,
    runs the coefficient-basis fallback and answers as the CPU backend of
    the same secrets; an open off the domain does too, without it."""
    from fourier_tpu_torch.models.piano import (PianoBackend, PianoFFTSettings,
                                                generate_trusted_setup)

    secrets = (bytes(range(32)), bytes(range(32, 64)))
    backends = []
    for dev in ("cpu", "cuda"):
        fft = PianoFFTSettings(5, 1, dev)
        backends.append(PianoBackend(fft, generate_trusted_setup(fft, secrets), dev, [dev]))
    cpu, card = backends
    rng = random.Random(0xFA11)
    row = [rng.randrange(R) for _ in range(card.fft.T)]
    for alpha, fallback in ((card.fft.left_roots[3], True), (rng.randrange(R), False)):
        TRACER.enable()
        try:
            got = card.worker_open(1, row, alpha)
        finally:
            TRACER.disable()
        spans = {s["name"]: s for s in TRACER.drain()}
        assert ("open.fallback" in spans) is fallback
        assert spans["open.quotient"]["launches"] == len(QUOTIENT_KERNELS)
        assert got == cpu.worker_open(1, row, alpha)
        assert card.worker_verify(1, card.worker_commit(1, row), alpha, *got)


def _every_wrapper(dev):
    """Each of the eight wrappers on tensors of dev, their results moved
    to the CPU, beside the plain twins' (K1 on a BGMW MSM's runs; the
    quotient's y and q)."""
    ps, qs = _lanes(40)
    tp = tcv.from_affine(tcv.affine_from_ints(ps))
    tq_aff = tcv.affine_from_ints(qs)
    tq = tcv.from_affine(tq_aff)
    sc = torch.as_tensor(ints_to_vec([random.Random(7).randrange(R) for _ in range(40)],
                                     FR_LIMBS).astype("int64"))
    table = tmsm.bgmw_expand(tq_aff, 9)
    packed = tmf.pack_points(table)
    index, start, count, _ = tmf.bucket_runs(table.inf, tmf.bgmw_digits_for(sc, 9, 29)[0], 9,
                                             tmf.bgmw_digits_for(sc, 9, 29)[1])
    p, q, q_aff = _to(tp, dev), _to(tq, dev), _to(tq_aff, dev)
    runs = [t.to(dev) for t in (packed, index, start, count)]
    pairs = [
        (kernels.accumulate(*runs), kernels.accumulate_plain(packed, index, start, count,
                                                             kernels.PIECE)),
        (kernels.g1_add(p, q), kernels.g1_add_plain(tp, tq)),
        (kernels.g1_tree_reduce([(q, -1, 1)])[0], kernels.g1_tree_reduce_plain(tq, -1, 1)),
        (kernels.g1_dbl(p, 2), kernels.g1_dbl_plain(tp, 2)),
        (kernels.horner_2k(q, 8), kernels.horner_2k_plain(tq, 8)),
        (kernels.g1_madd(p, q_aff), kernels.g1_madd_plain(tp, tq_aff)),
        (kernels.g1_madd_ladder(q_aff, sc.to(dev), 64),
         kernels.g1_madd_ladder_plain(tq_aff, sc, 64)),
    ]
    qargs = _quotient_case("random", 6, (2,), torch.device("cpu"))
    pairs.append((kernels.fr_quotient(*(t.to(dev) for t in qargs))[:2],
                  kernels.fr_quotient_plain(*qargs)[:2]))
    torch.cuda.synchronize(dev)
    return [(tuple(c.cpu() for c in got), want) for got, want in pairs]


@pytest.mark.cuda
def test_wrappers_launch_on_another_card_from_any_thread(cuda_device):
    """Every wrapper given tensors on cuda:1, from a thread whose current
    device is cuda:0, launches on cuda:1 and equals its plain twin."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    import threading

    out, errors = [], []
    before = dict(kernels.COUNTERS.launches)
    launched = {}

    def body():
        try:
            torch.cuda.set_device(0)
            out.extend(_every_wrapper(torch.device("cuda", 1)))
            launched.update((k, v - before[k]) for k, v in kernels.COUNTERS.launches.items()
                            if v > before[k])
            assert torch.cuda.current_device() == 0
        except BaseException as e:              # read below
            errors.append(e)

    th = threading.Thread(target=body)
    th.start()
    th.join(600)
    assert not th.is_alive() and not errors, errors
    assert set(launched) == set(kernels.KERNELS), launched
    for got, want in out:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_launch_counts_exact_with_four_threads(cuda_device):
    """Four threads launch K3 at once, 200 times each (on the card's
    current device, or one card each where there are four): the count is
    exact, and so is each thread's result."""
    import sys
    import threading

    n_cards = torch.cuda.device_count()
    ps, _ = _lanes(16)
    tp = tcv.from_affine(tcv.affine_from_ints(ps))
    want = kernels.g1_dbl_plain(tp, 1)
    kernels.build()
    before = kernels.COUNTERS.launches["g1_dbl"]
    results, errors = [None] * 4, []

    def body(k):
        try:
            dev = torch.device("cuda", k % n_cards)
            p = _to(tp, dev)
            for _ in range(200):
                out = kernels.g1_dbl(p)
            torch.cuda.synchronize(dev)
            results[k] = tcv.G1Jac(*(c.cpu() for c in out))
        except BaseException as e:              # read below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=body, args=(k,)) for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert kernels.COUNTERS.launches["g1_dbl"] - before == 800
    for got in results:
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_bgmw_msm_over_shards_of_cards_matches_one_card(cuda_device):
    """msm_fused_bgmw_sharded over a LocalMesh of 4 shards of the first
    card, and over every card where there are two or more, equals one
    card's MSM and refimpl."""
    from fourier_tpu_torch.parallel import msm_fused_sharded as mfs
    from fourier_tpu_torch.parallel.mesh import LocalMesh

    rng = random.Random(0x5E)
    n, c = 64, 9
    points = [g1_mul(G1_GEN, rng.randrange(1, R)) for _ in range(n)]
    scalars = [rng.randrange(R) for _ in range(n)]
    table = tmsm.bgmw_expand(tcv.affine_from_ints(points), c)
    packed, inf = tmf.pack_points(table).to(cuda_device), table.inf.to(cuda_device)
    sc = torch.as_tensor(ints_to_vec(scalars, FR_LIMBS).astype("int64")).to(cuda_device)
    want = tcv.jac_to_int_points(tcv.G1Jac(*(x[..., None] for x in tmf.msm_fused_bgmw(
        packed, inf, sc, c))))[0]
    assert want == g1_msm(points, scalars)
    meshes = [["cuda:0"] * 4]
    if torch.cuda.device_count() > 1:
        meshes.append([f"cuda:{i}" for i in range(torch.cuda.device_count())])
    for devices in meshes:
        got = LocalMesh(devices).run(lambda shard: tcv.jac_to_int_points(tcv.G1Jac(
            *(x[..., None] for x in mfs.msm_fused_bgmw_sharded(packed, inf, sc, c, shard))))[0])
        assert got == [want] * len(devices), devices
