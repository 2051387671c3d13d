"""TFHE parameter sets for the gate-bootstrapping core.

The reference obtains its parameters from
``new_default_gate_bootstrapping_parameters(110)``
(``/root/reference/Keygen/keygen.c:22-27``), i.e. the tfhe-lib lambda=110
gate-bootstrapping set: LWE dimension n=500, TRLWE degree N=1024, k=1,
gadget (Bgbit=10, l=2), keyswitch (basebit=2, t=8), noise stddevs
alpha_ks=2.44e-5 and alpha_bk=7.18e-9 (relative to the torus).

This rebuild keeps the security-relevant sizes (n, N, k, noise levels)
and swaps the *functional* knobs for int8-matmul-friendly ones:

* default gadget is (Bgbit=8, l=3): digits fit a single signed int8 limb,
  so the external-product polynomial matmuls run directly as
  s8 x s8 -> s32 integer matmuls, and decomposition precision improves from 20 to
  24 bits (strictly less decomposition noise than the reference's
  (10, 2) despite l growing 2->3).  The reference-compatible (10, 2)
  gadget is available as :data:`IEACHE_110_TFHE_COMPAT`.
* noise is sampled as a scaled centered binomial (sum of
  ``noise_bits`` fair bits) instead of a rounded Gaussian, so keygen and
  encryption are bit-exactly reproducible across the JAX implementation
  and the C++ oracle (``ieache/native``) from the same threefry
  streams.  With ``noise_bits = 1024`` the stddev is
  ``16 * scale`` torus units; scales below are chosen to match the
  reference stddevs:

  - bootstrapping/TRLWE noise: alpha_bk = 7.18e-9 * 2^32 = 30.8 torus
    units -> ``tlwe_noise_scale = 2`` gives sigma = 32 units
    (7.45e-9 relative; marginally *more* noise than the reference, i.e.
    at least as secure, and comfortably inside the correctness budget).
  - LWE/keyswitch noise: alpha_ks = 2.44e-5 * 2^32 = 104 805 units ->
    ``lwe_noise_scale = 6550`` gives sigma = 104 800 units.

Correctness budget (gate bootstrapping with message +-1/8, failure when
|noise phase| > 1/16): per-gate output noise stddev is ~4.4e-3 of the
torus (mod-switch ~3.2e-3, gadget decomposition ~1.7e-3, keyswitch
~2.5e-3), a >14-sigma margin — same regime as tfhe-lib's own
``max_stdev = 0.012467`` budget.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TFHEParams:
    """Parameter set for one TFHE gate-bootstrapping keyset.

    Mirrors the information content of tfhe-lib's
    ``TFheGateBootstrappingParameterSet`` (consumed by the reference at
    ``Keygen/keygen.c:22-27``) in an explicit dataclass.
    """

    # -- core dimensions ---------------------------------------------------
    n: int = 500          # LWE dimension (a-vector length)
    N: int = 1024         # TRLWE polynomial degree (power of two)
    k: int = 1            # number of TRLWE mask polynomials

    # -- TRGSW gadget decomposition ---------------------------------------
    bg_bit: int = 8       # log2 of the gadget base Bg
    l: int = 3            # number of gadget levels

    # -- LWE-to-LWE keyswitch ---------------------------------------------
    ks_basebit: int = 2   # log2 of the keyswitch decomposition base
    ks_t: int = 8         # number of keyswitch digits kept

    # -- noise (scaled centered binomial over `noise_bits` fair bits) ------
    lwe_noise_scale: int = 6550   # sigma = scale * sqrt(noise_bits)/2 units
    tlwe_noise_scale: int = 2
    noise_bits: int = 1024

    # -- bookkeeping --------------------------------------------------------
    name: str = "ieache_110"

    # ----------------------------------------------------------------------
    @property
    def bg(self) -> int:
        return 1 << self.bg_bit

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_basebit

    @property
    def kN(self) -> int:
        """Dimension of a sample-extracted LWE ciphertext."""
        return self.k * self.N

    @property
    def log2_2N(self) -> int:
        return int(math.log2(2 * self.N))

    @property
    def trgsw_rows(self) -> int:
        return (self.k + 1) * self.l

    @property
    def lwe_sigma_torus(self) -> float:
        """LWE noise stddev as a fraction of the torus."""
        return self.lwe_noise_scale * math.sqrt(self.noise_bits) / 2 / 2**32

    @property
    def tlwe_sigma_torus(self) -> float:
        return self.tlwe_noise_scale * math.sqrt(self.noise_bits) / 2 / 2**32

    def __post_init__(self):
        if self.N & (self.N - 1):
            raise ValueError(f"N must be a power of two, got {self.N}")
        if self.bg_bit * self.l > 32:
            raise ValueError("gadget covers more than 32 bits")
        if self.ks_basebit * self.ks_t > 32:
            raise ValueError("keyswitch gadget covers more than 32 bits")
        if self.bg_bit > 15:
            raise ValueError("gadget digits must fit two int8 limbs")

    @property
    def digit_limbs(self) -> int:
        """int8 limbs needed per gadget digit on the matmul path."""
        return 1 if self.bg_bit <= 8 else 2


#: Default parameter set: lambda=110 sizes with the int8-friendly gadget.
IEACHE_110 = TFHEParams()

#: Reference tfhe-lib gadget geometry (Bgbit=10, l=2), kept for parity
#: experiments.  Digits span 10 bits and therefore use two int8 limbs on
#: the matmul path.
IEACHE_110_TFHE_COMPAT = TFHEParams(
    bg_bit=10, l=2, name="ieache_110_tfhe_compat"
)

#: Throughput-tuned lambda=110 set: gadget (Bgbit=8, l=2) -> 4 TRGSW
#: rows instead of 6, i.e. 1/3 less blind-rotation matmul work per gate.
#: Security is unchanged (n, N, k, noise levels are those of
#: :data:`IEACHE_110`); only decomposition precision drops 24 -> 16
#: bits.  Correctness budget: the truncation term grows to
#: ~1.6e-3 torus stdev (n=500 steps x (1+kN) coefficients x
#: eps = 2^-17 uniform residue), while the BK-noise term *shrinks*
#: (4 rows instead of 6) to ~1.4e-3; combined with mod-switch
#: (~3.2e-3) and keyswitch (~2.5e-3) the output phase stdev is
#: ~4.6e-3 of the torus -> a ~13.5-sigma margin to the 1/16 failure
#: threshold at the worst-case (2x) next-gate input, the same regime
#: as IEACHE_110's ~14 sigma.  Validated empirically on hardware by
#: ``tools/margin_probe.py``.
IEACHE_110_FAST = TFHEParams(
    bg_bit=8, l=2, name="ieache_110_l2"
)

#: Tiny, *noiseless* parameters for fast unit tests on CPU.  Functional
#: structure is identical (all the same kernels run); with zero noise the
#: only error sources are mod-switch and gadget rounding, and n=8/N=64
#: keeps their worst case well inside the 1/16 phase margin.
TEST_TINY = TFHEParams(
    n=8,
    N=64,
    k=1,
    bg_bit=8,
    l=2,
    ks_basebit=4,
    ks_t=4,
    lwe_noise_scale=0,
    tlwe_noise_scale=0,
    noise_bits=1024,
    name="test_tiny",
)

#: Small-but-noisy parameters for statistical tests.
TEST_SMALL_NOISY = TFHEParams(
    n=64,
    N=256,
    k=1,
    bg_bit=8,
    l=3,
    ks_basebit=2,
    ks_t=8,
    lwe_noise_scale=16,
    tlwe_noise_scale=1,
    noise_bits=1024,
    name="test_small_noisy",
)
