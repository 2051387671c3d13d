"""Hopper external-product kernel (Pallas, Triton route).

The plain XLA step (``ops/blind_rotate.py``) materializes the
negacyclic Toeplitz operand of every TRGSW step in device memory —
(4, rows, k+1, N, N) int8, 33.5 MB at l=2 and 50 MB at l=3 — and
reads it back for the four limb GEMMs, 500 times per bootstrap wave,
whatever the batch.  This kernel never writes it: each block gathers
its Toeplitz limb tiles ``T_v[m, j] = limb_v(e[N + j - m])`` straight
from the 8 KB extended polynomial ``e = concat(-g, g)`` of each (p, o)
pair (stored as 16 shifted copies, so that each tile row is one aligned
run: 1.6 MB for a whole l=3 step, L2-resident), and feeds them to
the int8 tensor cores (s8 x s8 -> s32 ``tl.dot``).  Four int32
accumulators, one per torus limb, are recombined with wrapping shifts
once at the end, so the result is exact mod 2^32.

Blocks run in parallel and in no order, so the sum over the TRGSW
``rows`` axis is a loop inside the block.  At small batches the grid
would be a handful of blocks; there the contraction is split across
blocks (``split``) and the partial products are summed by XLA — integer
addition is exact in any order, so the result does not depend on it.

Only the single-limb gadget (bg_bit <= 8) runs here; the two-limb
compat gadget uses the plain step.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as pl_triton
from jax.sharding import NamedSharding, PartitionSpec as P

from ieache.core.poly import TORUS_LIMBS, negacyclic_extend, split_i8_limbs
from ieache.params import TFHEParams


@dataclasses.dataclass(frozen=True)
class Tiles:
    """Block shape of one kernel launch.

    bm: batch rows per block (tl.dot needs >= 16); bn: output
    coefficients per block; bk: contraction chunk; split: blocks that
    share one output tile's contraction, each taking an equal run of
    its rows·N/bk chunks.
    """

    bm: int
    bn: int
    bk: int
    split: int
    num_warps: int = 4
    num_stages: int = 3


#: batches above this run in full blocks of LARGE_BM lanes, plus one
#: launch for the remainder
LARGE_BM = 256

#: above this many lanes on a device, XLA's cuBLAS GEMM over the
#: materialized Toeplitz operand is faster than the kernel (its build
#: cost no longer dominates; measured on an H100, PERF.md)
KERNEL_MAX_LANES = 1536


def pick_tiles(b: int, params: TFHEParams) -> Tiles:
    """The block shape for a batch of ``b`` lanes — the one place the
    kernel's geometry is chosen (measured on an H100, PERF.md)."""
    n, rows = params.N, params.trgsw_rows
    if b <= 64:
        # latency shapes: many blocks, each taking 4 contraction chunks
        bk = min(64, n)
        chunks = rows * (n // bk)
        return Tiles(bm=max(16, 1 << (b - 1).bit_length()), bn=min(64, n),
                     bk=bk, split=chunks // 4 if chunks % 4 == 0 else 1)
    # rows = (k+1)·l is even, so split=2 always divides the contraction
    if b <= LARGE_BM:
        return Tiles(bm=128, bn=min(32, n), bk=min(256, n), split=2,
                     num_stages=2)
    return Tiles(bm=LARGE_BM, bn=min(32, n), bk=min(256, n), split=1,
                 num_warps=8, num_stages=2)


#: each extended polynomial is stored as ALIGN copies, copy c shifted
#: right by c bytes, so that every row of a Toeplitz tile is one
#: ALIGN-byte-aligned contiguous run (vector loads instead of bytes)
ALIGN = 16


def _ext_product_kernel(d_ref, e_ref, out_ref, *, n: int, rows: int,
                        kp1: int, tiles: Tiles):
    """One (bm, bn) output tile of poly o, summed over this block's
    share of the contraction.

    d_ref: (Bp, rows·N) int8 digits; e_ref: flat int8 limb planes,
    (k+1, rows, 4, ALIGN, 2N + ALIGN); out_ref: (bm, bn).
    """
    bm, bn, bk = tiles.bm, tiles.bn, tiles.bk
    width = 2 * n + ALIGN
    so = pl.program_id(0)
    o = jax.lax.rem(so, kp1)
    s = jax.lax.div(so, kp1)
    j0 = pl.program_id(1) * bn
    b0 = pl.program_id(2) * bm
    chunks = n // bk
    per_block = rows * chunks // tiles.split
    # T[m0 + mm, j0 + jj] = e[N + j0 - m0 - mm + jj]
    #                     = copy_c[N + j0 - m0 - (mm - c) + jj],  c = mm % ALIGN
    mm = jnp.arange(bk, dtype=jnp.int32)
    mm_hi = jax.lax.div(mm, ALIGN) * ALIGN
    row = (mm - mm_hi) * width + n - mm_hi                   # (bk,)
    window = row[:, None] + jnp.arange(bn, dtype=jnp.int32)[None, :]

    def body(i, accs):
        t = s * per_block + i
        p = jax.lax.div(t, chunks)
        m0 = jax.lax.rem(t, chunks) * bk
        dt = d_ref[pl.ds(b0, bm), pl.ds(p * n + m0, bk)]        # (bm, bk)
        base = (o * rows + p) * (TORUS_LIMBS * ALIGN * width) + j0 - m0
        out = []
        for v in range(TORUS_LIMBS):
            g = e_ref[base + v * ALIGN * width + window]         # (bk, bn)
            out.append(accs[v] + jax.lax.dot_general(
                dt, g, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32))
        return tuple(out)

    zero = jnp.zeros((bm, bn), jnp.int32)
    a = jax.lax.fori_loop(0, per_block, body, (zero,) * 4)
    out_ref[...] = a[0] + (a[1] << 8) + (a[2] << 16) + (a[3] << 24)


def limb_planes(bk_i: jnp.ndarray) -> jnp.ndarray:
    """bk_i (rows, k+1, N) int32 -> flat int8 limb planes of
    e = concat(-g, g), laid out (k+1, rows, 4, ALIGN, 2N + ALIGN) with
    copy c holding e shifted right by c (zeros around it)."""
    el = split_i8_limbs(negacyclic_extend(bk_i))   # (rows, kp1, 2N, 4)
    el = jnp.transpose(el, (1, 0, 3, 2))           # (kp1, rows, 4, 2N)
    copies = [jnp.pad(el, ((0, 0),) * 3 + ((c, ALIGN - c),))
              for c in range(ALIGN)]
    return jnp.stack(copies, axis=3).reshape(-1)


def _product(d8: jnp.ndarray, planes: jnp.ndarray, bk_i: jnp.ndarray,
             params: TFHEParams, interpret: bool,
             tiles: Tiles | None) -> jnp.ndarray:
    """d8 (B, rows·N) int8 -> (B, k+1, N) int32, on the batch this
    device holds: more than KERNEL_MAX_LANES lanes go to XLA's
    :func:`plain_product`; otherwise full LARGE_BM blocks run in one
    launch and the remainder in a second one rather than padded."""
    b = d8.shape[0]
    if tiles is None and b > KERNEL_MAX_LANES:
        from ieache.ops.blind_rotate import plain_product

        return plain_product(
            d8.reshape(b, params.trgsw_rows, params.N), bk_i, params)
    main = b - b % LARGE_BM
    if tiles is None and main > 0 and main != b:
        return jnp.concatenate(
            [_launch(d8[:main], planes, params, interpret,
                     pick_tiles(main, params)),
             _launch(d8[main:], planes, params, interpret,
                     pick_tiles(b - main, params))], axis=0)
    return _launch(d8, planes, params, interpret,
                   tiles or pick_tiles(b, params))


def _launch(d8: jnp.ndarray, planes: jnp.ndarray, params: TFHEParams,
            interpret: bool, tiles: Tiles) -> jnp.ndarray:
    b = d8.shape[0]
    n, rows, kp1 = params.N, params.trgsw_rows, params.k + 1
    if n % tiles.bn or n % tiles.bk or (rows * n // tiles.bk) % tiles.split:
        raise ValueError(f"tiles {tiles} do not divide N={n}, rows={rows}")
    bp = -(-b // tiles.bm) * tiles.bm
    if bp != b:
        d8 = jnp.pad(d8, ((0, bp - b), (0, 0)))
    out = pl.pallas_call(
        functools.partial(_ext_product_kernel, n=n, rows=rows, kp1=kp1,
                          tiles=tiles),
        grid=(kp1 * tiles.split, n // tiles.bn, bp // tiles.bm),
        in_specs=[pl.no_block_spec, pl.no_block_spec],
        out_specs=pl.BlockSpec(
            (None, tiles.bm, None, tiles.bn),
            lambda so, ji, bi: (so // kp1, bi, so % kp1, ji)),
        out_shape=jax.ShapeDtypeStruct((tiles.split, bp, kp1, n),
                                       jnp.int32, vma=jax.typeof(d8).vma),
        compiler_params=pl_triton.CompilerParams(
            num_warps=tiles.num_warps, num_stages=tiles.num_stages),
        backend="triton",
        interpret=interpret,
        name="ext_product_hopper",
    )(d8, planes)
    out = out[0] if tiles.split == 1 else out.sum(0, dtype=jnp.int32)
    return out[:b]


@functools.lru_cache(maxsize=None)
def _batch_partitioned(params: TFHEParams, interpret: bool,
                       tiles: Tiles | None):
    """:func:`_product` as an op that XLA's partitioner splits along
    the batch: under a dp-sharded jit each device runs the kernel on
    its own lanes (the planes are replicated), instead of gathering the
    whole batch onto every device."""

    @custom_partitioning
    def product(d8, planes, bk_i):
        return _product(d8, planes, bk_i, params, interpret, tiles)

    def shardings(mesh, arg_shapes):
        spec = getattr(arg_shapes[0].sharding, "spec", ())
        batch_axis = spec[0] if len(spec) else None
        return (NamedSharding(mesh, P(batch_axis, None, None)),
                (NamedSharding(mesh, P(batch_axis, None)),
                 NamedSharding(mesh, P(None)),
                 NamedSharding(mesh, P(None, None, None))))

    def partition(mesh, arg_shapes, result_shape):
        out_sharding, arg_shardings = shardings(mesh, arg_shapes)
        return (mesh,
                lambda d8, planes, bk_i: _product(
                    d8, planes, bk_i, params, interpret, tiles),
                out_sharding, arg_shardings)

    product.def_partition(
        partition=partition,
        infer_sharding_from_operands=(
            lambda mesh, arg_shapes, result_shape:
            shardings(mesh, arg_shapes)[0]),
        sharding_rule="b k, p, r q m -> b o n",
        need_replication_factors=("k", "p", "r", "q", "m"),
    )
    return product


@functools.partial(jax.jit, static_argnames=("params", "interpret", "tiles"))
def external_product(
    digits: jnp.ndarray, bk_i: jnp.ndarray, params: TFHEParams,
    interpret: bool = False, tiles: Tiles | None = None,
) -> jnp.ndarray:
    """digits (B, rows, N) (int8-valued) x bk_i (rows, k+1, N) int32
    -> (B, k+1, N) int32 external product, exact mod 2^32.

    Any B: the batch is padded with zero digits to the block height
    and sliced back; above KERNEL_MAX_LANES lanes per device the plain
    contraction runs instead.  A batch sharded over devices stays
    sharded.
    """
    if params.digit_limbs != 1:
        raise ValueError("the external-product kernel needs single-limb "
                         "digits (bg_bit <= 8)")
    b = digits.shape[0]
    d8 = digits.reshape(b, params.trgsw_rows * params.N).astype(jnp.int8)
    return _batch_partitioned(params, interpret, tiles)(
        d8, limb_planes(bk_i), bk_i)
