"""BLS12-381 constants shared by the whole port (a copy of
``fourier_tpu.constants``, which the port does not import).

Everything here is a plain Python integer (host-side).  Device-side limb
encodings are derived from these in :mod:`fourier_tpu_torch.ops.limbs`.

Parity notes (behavior replicated from the reference, apollozkp/fourier):
- Scalar field Fr and base field Fp moduli match blst 0.3.11
  (reference Cargo.toml:29) — the curve parameters are the public
  BLS12-381 spec, not copied code.
- Roots of unity follow the c-kzg / rust-kzg convention: the primitive
  root of the 2^s-order subgroup is ``7^((r-1) / 2^s) mod r`` where 7 is
  the smallest multiplicative generator of Fr.  This is what
  ``FsFFTSettings::new(scale)`` uses (reference src/engine/piano.rs:1067).
"""

# ---------------------------------------------------------------------------
# Field moduli
# ---------------------------------------------------------------------------

# Base field modulus (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Scalar field modulus (255 bits), the order of G1/G2
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (the curve is parameterised by x = -0xd201000000010000)
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

# Curve equation: y^2 = x^3 + 4 over Fp;  twist: y^2 = x^3 + 4(u+1) over Fp2
B_COEFF = 4

# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# G2 generator, coordinates in Fp2 = Fp[u]/(u^2+1), written (c0, c1)
G2_GENERATOR_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GENERATOR_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# ---------------------------------------------------------------------------
# Fr multiplicative structure
# ---------------------------------------------------------------------------

# Smallest multiplicative generator of Fr* (c-kzg PRIMITIVE_ROOT_OF_UNITY)
FR_GENERATOR = 7

# 2-adicity of r - 1
FR_TWO_ADICITY = 32


def root_of_unity(scale: int) -> int:
    """Primitive 2^scale-th root of unity in Fr (c-kzg convention)."""
    if not 0 <= scale <= FR_TWO_ADICITY:
        raise ValueError(f"scale {scale} out of range [0, {FR_TWO_ADICITY}]")
    return pow(FR_GENERATOR, (R - 1) >> scale, R)


# ---------------------------------------------------------------------------
# Limb layout (device representation)
# ---------------------------------------------------------------------------

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
FR_LIMBS = 16   # 16 * 16 = 256 bits >= 255
FP_LIMBS = 24   # 24 * 16 = 384 bits >= 381

# Montgomery radix per field
FR_MONT_R = (1 << (LIMB_BITS * FR_LIMBS)) % R         # 2^256 mod r
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R
FR_MONT_INV = (-pow(R, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)   # -r^-1 mod 2^16

FP_MONT_R = (1 << (LIMB_BITS * FP_LIMBS)) % P         # 2^384 mod p
FP_MONT_R2 = (FP_MONT_R * FP_MONT_R) % P
FP_MONT_INV = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)   # -p^-1 mod 2^16


def to_limbs(x: int, n_limbs: int) -> list[int]:
    """Little-endian 16-bit limb decomposition of a non-negative int."""
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)]


def from_limbs(limbs) -> int:
    """Inverse of :func:`to_limbs`."""
    out = 0
    for i, limb in enumerate(limbs):
        out |= int(limb) << (LIMB_BITS * i)
    return out
