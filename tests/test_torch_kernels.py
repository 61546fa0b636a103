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
(msm through K1, K2, K4; msm_naive through K3, K5, K2).  Comparisons are
exact.
"""

import random

import pytest
import torch

from fourier_tpu_torch.constants import FR_LIMBS, R
from fourier_tpu_torch.ops.limbs import ints_to_vec
from fourier_tpu_torch.refimpl.curve import G1_GEN, g1_add, g1_msm, g1_mul, g1_neg
from fourier_tpu_torch.ops import curve as tcv
from fourier_tpu_torch.ops import kernels
from fourier_tpu_torch.ops import msm as tmsm
from fourier_tpu_torch.ops import msm_fused as tmf

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
