"""Blind rotation — the hot core of TFHE gate bootstrapping.

Replaces the reference's per-gate CPU blind rotation inside tfhe-lib
(every ``bootsAND/XOR/NOT`` at ``/root/reference/Cloud/cloud.c:30-43``
costs one of these).  Design:

* one CMux step per LWE mask coefficient:
  ``acc <- acc + BK_i ⊡ (X^bara_i · acc - acc)``
* the external product ``⊡`` is flattened into int8 matmuls:
  digits ``D (B, rows·N)`` x negacyclic-Toeplitz matrix
  ``G (rows·N, (k+1)·N)`` of the step's TRGSW polynomials, split into
  four signed int8 torus limbs.  Each ``s8 x s8 -> s32`` matmul is
  exact; limb recombination with wrapping shifts is exact mod 2^32.
* the plain step builds G per step from the (n, rows, k+1, N) BK
  tensor with log2(N) static rolls; the Hopper kernel
  (``ops/pallas_kernels.py``) gathers G's tiles on chip instead.
* per-gate rotation amounts (bara) make X^bara a batched negacyclic
  roll, done as a barrel shifter of static rolls.

Work per bootstrap: n=500 steps x 4 limb-matmuls x (B, rows·N) x
(rows·N, (k+1)·N) — 4 x 6144 x 2048 ≈ 50 M int8 MACs per lane per
step at l=3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ieache.core.poly import (
    TORUS_LIMBS,
    _toeplitz_from_extended,
    _toeplitz_rows,
    negacyclic_extend,
    split_i8_limbs,
)
from ieache.ops.decompose import gadget_decompose
from ieache.params import TFHEParams


def make_step_gmatrix(bk_step: jnp.ndarray, params: TFHEParams) -> jnp.ndarray:
    """TRGSW step -> negacyclic matmul operand (Toeplitz tensor).

    bk_step: int32 (rows, k+1, N) -> int8 (TORUS_LIMBS, rows, k+1, N, N)
    with G[v, p, o, m, j] = limb_v( e_{p,o}[N + j - m] ), e = concat(-g, g).
    Kept in this axis order (no transposes/reshapes across non-adjacent
    axes — those cost ~100 MB of relayout per step); the consumer uses
    a multi-dimension dot_general contraction instead.
    """
    n = params.N
    e = negacyclic_extend(bk_step)            # (rows, k+1, 2N) int32
    el = split_i8_limbs(e)                    # (rows, k+1, 2N, L) int8
    el = jnp.moveaxis(el, -1, 0)              # (L, rows, k+1, 2N)
    t = _toeplitz_from_extended(el, n)        # (L, rows, k+1, N, 2N)
    return t[..., n:]                         # (L, rows, k+1, N, N)


def make_step_gmatrix_local(
    bk_step: jnp.ndarray, params: TFHEParams, start: jnp.ndarray,
    n_local: int,
) -> jnp.ndarray:
    """Columns [start, start+n_local) of the step's Toeplitz operand,
    WITHOUT materializing the full (N, 2N) row tensor.

    The SP-sharded bootstrap's memory fix (VERDICT r3): with
    ``T[m, j] = e[N + j - m]``, the local block only reads the window
    ``ew[t] = e[start+1+t]`` of length N + n_local - 1, and splitting
    the m axis into N/n_local blocks makes each block a small
    (n_local, 2·n_local−1) windowed Toeplitz — peak transient is the
    output block (÷sp of the full build) plus one build window, so
    per-device memory actually shrinks with sp (the full-size-build
    + dynamic-slice r3 version shrank only FLOPs).

    ``start`` may be traced (``jax.lax.axis_index``): it only feeds a
    dynamic_slice of ``e``; all block offsets within the window are
    static.

    bk_step: int32 (rows, k+1, N) -> int8 (L, rows, k+1, N, n_local);
    bit-identical to ``make_step_gmatrix(...)[..., start:start+n_local]``.
    """
    n = params.N
    if n % n_local:
        raise ValueError(f"n_local={n_local} must divide N={n}")
    e = negacyclic_extend(bk_step)               # (rows, k+1, 2N) int32
    ew = jax.lax.dynamic_slice_in_dim(
        e, start + 1, n + n_local - 1, axis=-1
    )
    el = split_i8_limbs(ew)                      # (rows, k+1, L', L)
    el = jnp.moveaxis(el, -1, 0)                 # (L, rows, k+1, L')
    blocks = []
    for q in range(n // n_local):
        # rows m = q*n_local + r:  T[m, jj] = wq[(n_local-1) + jj - r]
        lo = n - (q + 1) * n_local
        wq = jax.lax.slice_in_dim(
            el, lo, lo + 2 * n_local - 1, axis=-1
        )
        rows = _toeplitz_rows(wq, n_local)       # (..., n_local, 2nl-1)
        blocks.append(rows[..., n_local - 1:])   # (..., n_local, n_local)
    return jnp.concatenate(blocks, axis=-2)      # (L, rows, k+1, N, nl)


def negacyclic_rotate_batch(acc: jnp.ndarray, amount: jnp.ndarray) -> jnp.ndarray:
    """X^amount · acc for per-batch amounts in [0, 2N).

    acc: (B, k+1, N) int32; amount: (B,) int32 -> (B, k+1, N).

    Implemented as a barrel shifter: log2(2N) stages of conditional
    *static* negacyclic rolls (selects + rolls), pure elementwise
    traffic that XLA fuses, instead of a per-row dynamic gather.
    """
    n = acc.shape[-1]
    j = jnp.arange(n, dtype=jnp.int32)[None, None, :]
    x = acc
    # stage for shift amount 2^t, t = 0 .. log2(2N)-1; a shift by N or
    # more is  X^N == -1  times the shift-by-(s-N) — handled naturally
    # by the sign-flip mask of each static roll.
    shift = 1
    for t in range(params_log2_2n(n)):
        bit = ((amount >> t) & 1).astype(jnp.bool_)[:, None, None]
        if shift < n:
            rolled = jnp.roll(x, shift, axis=-1)
            rolled = jnp.where(j < shift, -rolled, rolled)
        else:  # shift == N: X^N * x == -x
            rolled = -x
        x = jnp.where(bit, rolled, x)
        shift *= 2
    return x


def params_log2_2n(n: int) -> int:
    return int(2 * n).bit_length() - 1


def _step_digits(acc: jnp.ndarray, bara_i: jnp.ndarray,
                 params: TFHEParams) -> jnp.ndarray:
    """Digits of (X^bara·acc - acc): int32 (B, rows, N)."""
    b = acc.shape[0]
    diff = negacyclic_rotate_batch(acc, bara_i) - acc      # (B, k+1, N)
    digits = gadget_decompose(diff, params.bg_bit, params.l)
    # (B, k+1, N, l) -> (B, k+1, l, N): row p = u*l + j matches BK layout
    digits = jnp.moveaxis(digits, -1, 2)
    return digits.reshape(b, params.trgsw_rows, params.N)


def _dot_digits_g(d8: jnp.ndarray, gv: jnp.ndarray) -> jnp.ndarray:
    """(B, rows, m) x (rows, kp1, m, j) -> (B, kp1, j), s8 x s8 -> s32."""
    return jax.lax.dot_general(
        d8, gv,
        dimension_numbers=(((1, 2), (0, 2)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def step_impl(params: TFHEParams) -> str:
    """The CMux step, chosen in one place: the Hopper external-product
    kernel (``"kernel"``) on a GPU for the single-limb gadget — it takes
    each device's lanes up to ``pallas_kernels.KERNEL_MAX_LANES`` and
    hands larger batches to :func:`plain_product`; the plain XLA step
    (``"plain"``) elsewhere and inside ``shard_map`` (the kernel is
    partitioned by XLA over a sharded batch, not written for manual
    axes).  ``IEACHE_STEP=plain|kernel|ntt`` overrides the choice (ntt:
    the CRT-NTT step).  Interpret mode (``"interpret"``) is only ever
    passed explicitly."""
    import os

    forced = os.environ.get("IEACHE_STEP", "")
    if forced:
        if forced not in ("plain", "kernel", "ntt"):
            raise ValueError(f"IEACHE_STEP must be plain, kernel or ntt, "
                             f"got {forced!r}")
        if forced != "plain" and params.digit_limbs != 1:
            raise ValueError(f"IEACHE_STEP={forced} needs digit_limbs == 1 "
                             f"(got {params.digit_limbs})")
        return forced
    if (jax.default_backend() == "gpu" and params.digit_limbs == 1
            and not jax.sharding.get_abstract_mesh().manual_axes):
        return "kernel"
    return "plain"


def contract_limbs(d: jnp.ndarray, g: jnp.ndarray,
                   params: TFHEParams) -> jnp.ndarray:
    """digits d (B, rows, N) int32 x Toeplitz limbs g (L, rows, k+1, N,
    n_out) -> (B, k+1, n_out) int32, exact mod 2^32 (wrapping limb
    shifts; the two-limb gadget splits the digits too)."""
    if params.digit_limbs == 1:
        d8 = d.astype(jnp.int8)
        return sum(_dot_digits_g(d8, g[v]) << (8 * v)
                   for v in range(TORUS_LIMBS))
    dl = split_i8_limbs(d, params.digit_limbs)             # (B, rows, N, 2)
    return sum(_dot_digits_g(dl[..., u], g[v]) << (8 * (u + v))
               for u in range(params.digit_limbs)
               for v in range(TORUS_LIMBS) if u + v < TORUS_LIMBS)


def plain_product(d: jnp.ndarray, bk_i: jnp.ndarray,
                  params: TFHEParams) -> jnp.ndarray:
    """BK_i ⊡ digits through the materialized Toeplitz operand:
    d (B, rows, N) -> (B, k+1, N) int32.  XLA merges the limb dots into
    one int8 GEMM."""
    return contract_limbs(d, make_step_gmatrix(bk_i, params), params)


def external_product_step(
    acc: jnp.ndarray, bara_i: jnp.ndarray, bk_i: jnp.ndarray,
    params: TFHEParams, impl: str = "plain",
) -> jnp.ndarray:
    """One CMux: acc + BK_i ⊡ (X^bara_i · acc - acc).  Exact mod 2^32.

    ``impl``: ``"plain"`` (XLA), ``"kernel"`` (the Hopper kernel, up to
    its lane limit) or ``"interpret"`` (that in Pallas interpret mode)."""
    d = _step_digits(acc, bara_i, params)                  # (B, rows, N)
    if impl in ("kernel", "interpret"):
        from ieache.ops.pallas_kernels import external_product

        return acc + external_product(d, bk_i, params,
                                      interpret=impl == "interpret")
    return acc + plain_product(d, bk_i, params)


def external_product_step_sharded(
    acc: jnp.ndarray, bara_i: jnp.ndarray, bk_i_local: jnp.ndarray,
    params: TFHEParams, tp_axis: str,
) -> jnp.ndarray:
    """Tensor-parallel CMux step (runs inside shard_map).

    The TRGSW `rows` axis is sharded over `tp_axis`: each shard holds
    ``bk_i_local (rows/tp, k+1, N)``, builds only its G slice, contracts
    it against its digit slice, and the partial external products are
    combined with one ``psum`` across devices.  acc stays replicated
    across tp (it is dp-sharded over the batch).
    """
    rows_local = bk_i_local.shape[0]
    digits = _step_digits(acc, bara_i, params)             # (B, rows, N)
    start = jax.lax.axis_index(tp_axis) * rows_local
    d_local = jax.lax.dynamic_slice_in_dim(digits, start, rows_local, 1)
    return acc + jax.lax.psum(plain_product(d_local, bk_i_local, params),
                              tp_axis)


def blind_rotate_sharded(
    acc0: jnp.ndarray, bara: jnp.ndarray, bk_local: jnp.ndarray,
    params: TFHEParams, tp_axis: str, overlap_chunks: int = 2,
) -> jnp.ndarray:
    """Blind rotation with the BK rows axis sharded over `tp_axis`.

    ``overlap_chunks``: the tp psum sits on the CMux scan's serial
    critical path (psum_i -> decompose_{i+1} -> dots_{i+1} -> ...;
    it cannot be deferred across steps because gadget decomposition
    is nonlinear).  Splitting the per-shard batch into C independent
    sub-chunks breaks each step into C dependency chains, so chunk
    c+1's matmuls have no dependence on chunk c's psum and XLA's
    async collectives can run them concurrently (software pipelining
    over the batch, VERDICT r4 directive #5).  Bit-exact for any C:
    the math per lane is unchanged (tests/test_dist.py).  C=1
    restores the unpipelined r4 schedule.
    """
    b = acc0.shape[0]
    if overlap_chunks > 1 and b % overlap_chunks == 0 and \
            b >= 2 * overlap_chunks:
        nc = overlap_chunks

        def step(acc, xs):
            bk_i, bara_i = xs
            outs = [
                external_product_step_sharded(
                    acc[c * (b // nc):(c + 1) * (b // nc)],
                    bara_i[c * (b // nc):(c + 1) * (b // nc)],
                    bk_i, params, tp_axis,
                )
                for c in range(nc)
            ]
            return jnp.concatenate(outs, axis=0), None
    else:
        def step(acc, xs):
            bk_i, bara_i = xs
            return (
                external_product_step_sharded(acc, bara_i, bk_i, params,
                                              tp_axis),
                None,
            )

    acc, _ = jax.lax.scan(step, acc0, (bk_local, bara.T))
    return acc


def _blind_rotate_ntt(
    acc0: jnp.ndarray, bara: jnp.ndarray, bk: jnp.ndarray,
    params: TFHEParams,
) -> jnp.ndarray:
    """Blind rotation with the CRT-NTT external product
    (core/ntt.py) — the O(N log N)-per-lane small-batch path
    (IEACHE_STEP=ntt).

    The BK spectra are computed once per call and fed through the scan
    (500 x (P=2, limbs=4, rows, k+1, N) uint32 ~ 131 MB at lambda=110
    — amortized over the whole wave); each step forward-transforms
    only the digits, sums the rows-contraction in the spectral domain,
    and CRT-recombines four byte-limb convolutions exactly mod 2^32.
    Range: |sum over rows*N of d*s_v| <= rows * N * 128 * 128 — within
    the two-prime CRT range for rows <= 6 (both shipped gadgets).
    Bit-identical to the Toeplitz paths (tests/test_ntt.py)."""
    from ieache.core import ntt

    n = params.N
    # CRT dynamic-range guard (exactness invariant): every byte-limb
    # convolution must satisfy |sum over rows*N of d*s_v| < P/2 with
    # P = 12289*18433.  |d| <= 2^(bg_bit-1), |s_v| <= 128.
    bound = params.trgsw_rows * n * (1 << (params.bg_bit - 1)) * 128
    if bound >= (ntt.PRIMES[0] * ntt.PRIMES[1]) // 2:
        raise ValueError(
            f"CRT-NTT range exceeded: rows*N*2^(bg_bit-1)*128 = {bound}"
            f" >= P/2 = {(ntt.PRIMES[0] * ntt.PRIMES[1]) // 2}; the"
            " two-prime byte-limb path needs rows <= 6 at N=1024,"
            " bg_bit=8 — use the Toeplitz path for wider gadgets"
        )
    bkhat = ntt.ntt_forward_torus_limbs(bk, n)   # (P, 4, steps, r, kp1, N)
    bkhat = jnp.moveaxis(bkhat, 2, 0)            # (steps, P, 4, r, kp1, N)
    nprimes = len(ntt.PRIMES)

    def step(acc, xs):
        bkhat_i, bara_i = xs
        digits = _step_digits(acc, bara_i, params)   # (B, rows, N)
        dh = ntt.ntt_forward_digits(digits, n)       # (P, B, rows, N)
        out = jnp.zeros_like(acc)
        for v in range(4):
            res = []
            for pi in range(nprimes):
                prod = ntt.ntt_pointwise(
                    dh[pi][:, :, None, :],
                    bkhat_i[pi, v][None, :, :, :], pi, n,
                )                                    # (B, rows, kp1, N)
                acc_p = prod[:, 0]
                for r in range(1, prod.shape[1]):
                    acc_p = ntt._add_mod(acc_p, prod[:, r],
                                         ntt.PRIMES[pi])
                res.append(ntt.ntt_inverse(acc_p, pi, n))
            out = out + (ntt.crt_to_int32(res[0], res[1], n=n)
                         << (8 * v))
        return acc + out, None

    acc, _ = jax.lax.scan(step, acc0, (bkhat, bara.T))
    return acc


def blind_rotate(
    acc0: jnp.ndarray, bara: jnp.ndarray, bk: jnp.ndarray,
    params: TFHEParams, impl: str | None = None,
) -> jnp.ndarray:
    """Full blind rotation over all n LWE coefficients.

    acc0: (B, k+1, N) int32 — rotated test-vector accumulator.
    bara: (B, n) int32 in [0, 2N) — mod-switched mask coefficients.
    bk:   (n, rows, k+1, N) int32 — bootstrapping key.
    impl: the CMux step; ``None`` takes :func:`step_impl`'s choice.
    """
    impl = impl or step_impl(params)
    if impl == "ntt":
        return _blind_rotate_ntt(acc0, bara, bk, params)

    def step(acc, xs):
        bk_i, bara_i = xs
        return external_product_step(acc, bara_i, bk_i, params, impl), None

    acc, _ = jax.lax.scan(step, acc0, (bk, bara.T))
    return acc
