"""Sharded (multi-chip) gate bootstrapping via shard_map.

Parallelism surface (SURVEY §2 parallelism table):

* ``dp``: the gate batch is sharded — the reference's "independent
  gates under OpenMP sections / multi-client fan-out" axis;
* ``tp``: the external-product contraction (TRGSW rows) and the
  keyswitch contraction (kN*t) are sharded; each blind-rotation step
  ends in one ``psum`` over tp (XLA collectives over ICI), and the
  bootstrapping/keyswitch keys are memory-sharded accordingly;
* ``pp``: pipeline parallelism over expression-chain stages is
  device-level in ieache/dist/pipeline.py (microbatched GPipe
  schedule, ppermute handoff — the analog of the reference's
  Cloud answer.data re-upload chain); the host-level counterpart of
  the Keygen->Client->Cloud->Output pipeline is the scheduler
  (ieache/mp/scheduler.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ieache.boot.bootstrap import (
    MU,
    DeviceCloudKey,
    _rotated_test_vector,
    mod_switch_2n,
    sample_extract,
)
from ieache.core.poly import TORUS_LIMBS
from ieache.ops.blind_rotate import (
    _step_digits,
    blind_rotate_sharded,
    contract_limbs,
    make_step_gmatrix_local,
)
from ieache.ops.decompose import gadget_decompose
from ieache.params import TFHEParams


def _keyswitch_sharded(lwe_ext, ks_local, params: TFHEParams, tp_axis: str):
    """Keyswitch with the (kN*t) contraction sharded over tp."""
    b_dim = lwe_ext.shape[0]
    kn, t, n = params.kN, params.ks_t, params.n
    a = lwe_ext[:, :kn]
    body = lwe_ext[:, kn]

    digits = gadget_decompose(a, params.ks_basebit, t).reshape(
        b_dim, kn * t
    )
    k_local = ks_local.shape[1]
    start = jax.lax.axis_index(tp_axis) * k_local
    d8 = jax.lax.dynamic_slice_in_dim(digits, start, k_local, 1).astype(
        jnp.int8
    )

    acc = jnp.zeros((b_dim, n + 1), jnp.int32)
    for v in range(TORUS_LIMBS):
        part = jax.lax.dot_general(
            d8, ks_local[v],
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        acc = acc + (part << (8 * v))
    acc = jax.lax.psum(acc, tp_axis)
    out = -acc
    out = out.at[:, n].add(body)
    return out


def make_sharded_bootstrap(mesh: Mesh, params: TFHEParams, mu: int = MU,
                           overlap_chunks: int = 2):
    """Build a jitted sharded bootstrap: (lwe, bk, ks_limbs) -> lwe_out.

    lwe is dp-sharded on the batch; bk's TRGSW-rows axis and
    ks_limbs' contraction axis are tp-sharded.  `tp` must divide
    (k+1)*l and kN*ks_t.  ``overlap_chunks`` batch-pipelines the
    per-step tp psum against the next sub-chunk's matmuls (see
    :func:`ieache.ops.blind_rotate.blind_rotate_sharded`).
    """
    tp = mesh.shape["tp"]
    if params.trgsw_rows % tp or (params.kN * params.ks_t) % tp:
        raise ValueError(f"tp={tp} must divide TRGSW rows and kN*t")

    def fn(lwe, bk_local, ks_local):
        p = params
        n = p.n
        a, b = lwe[:, :n], lwe[:, n]
        bara = mod_switch_2n(a, p)
        barb = mod_switch_2n(b, p)
        acc0 = jnp.zeros((lwe.shape[0], p.k + 1, p.N), jnp.int32)
        acc0 = acc0.at[:, p.k, :].set(_rotated_test_vector(barb, mu, p))
        acc = blind_rotate_sharded(acc0, bara, bk_local, p, "tp",
                                   overlap_chunks=overlap_chunks)
        ext = sample_extract(acc, p)
        return _keyswitch_sharded(ext, ks_local, p, "tp")

    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(
            P("dp", None),
            P(None, "tp", None, None),
            P(None, "tp", None),
        ),
        out_specs=P("dp", None),
    )
    return jax.jit(mapped)


def make_sp_mesh(n_devices: int, sp: int, devices=None) -> Mesh:
    """(dp, sp) mesh: batch-parallel x polynomial-dimension-parallel."""
    devices = list(devices or jax.devices())
    if n_devices % sp:
        raise ValueError(f"n_devices {n_devices} not divisible by {sp}")
    arr = np.array(devices[:n_devices]).reshape(n_devices // sp, sp)
    return Mesh(arr, axis_names=("dp", "sp"))


def _external_product_step_sp(acc_local, bara_i, bk_i,
                              params: TFHEParams, sp_axis: str):
    """CMux step with the accumulator's polynomial axis N sharded.

    This is the SURVEY §5.7 "true SP counterpart": the per-bootstrap
    polynomial dimension is split over chips the way sequence
    parallelism splits a long sequence, with one collective per stage
    standing in for the NTT's butterfly all-to-all.  Each step:

    1. ``all_gather`` the N-sharded accumulator over ``sp`` (the
       negacyclic rotation mixes every coefficient, exactly like an
       NTT stage);
    2. rotate + diff + gadget-decompose on the gathered copy
       (replicated work — it is ~1% of the step's FLOPs);
    3. contract the digits against only the LOCAL column block of the
       step's Toeplitz operand, built directly at local size by
       ``make_step_gmatrix_local`` (r4: the windowed block build —
       per-device transient G is the (N, N/sp) block + one
       (N/sp, 2N/sp) build window, so BOTH the matmul work and the peak
       transient memory shrink with sp; the r3 version built the full
       (N, 2N) rows per device and only sliced afterwards);
    4. the output block IS this shard's new acc slice (no reduce
       needed: the contraction is over rows x full-N, sharded on the
       output axis j, unlike tp which shards the contraction axis and
       psums).
    """
    n_local = acc_local.shape[-1]
    acc_full = jax.lax.all_gather(
        acc_local, sp_axis, axis=acc_local.ndim - 1, tiled=True
    )                                                    # (B, k+1, N)
    digits = _step_digits(acc_full, bara_i, params)      # (B, rows, N)
    start = jax.lax.axis_index(sp_axis) * n_local
    g_local = make_step_gmatrix_local(bk_i, params, start, n_local)
    return acc_local + contract_limbs(digits, g_local, params)


def make_sharded_bootstrap_sp(mesh: Mesh, params: TFHEParams,
                              mu: int = MU):
    """Bootstrap with dp over the batch and sp over the polynomial
    dimension N (keys replicated; one all_gather per blind-rotation
    step rides the ICI).  Bit-exact vs the single-device pipeline
    (tests/test_dist.py)."""
    sp = mesh.shape["sp"]
    if params.N % sp:
        raise ValueError(f"sp={sp} must divide N={params.N}")
    n_local = params.N // sp

    def fn(lwe, bk, ks_limbs):
        p = params
        n = p.n
        a, b = lwe[:, :n], lwe[:, n]
        bara = mod_switch_2n(a, p)
        barb = mod_switch_2n(b, p)
        acc0 = jnp.zeros((lwe.shape[0], p.k + 1, p.N), jnp.int32)
        acc0 = acc0.at[:, p.k, :].set(_rotated_test_vector(barb, mu, p))
        start = jax.lax.axis_index("sp") * n_local
        acc_local = jax.lax.dynamic_slice_in_dim(acc0, start, n_local, 2)

        def step(acc, xs):
            bk_i, bara_i = xs
            return (
                _external_product_step_sp(acc, bara_i, bk_i, p, "sp"),
                None,
            )

        acc_local, _ = jax.lax.scan(step, acc_local, (bk, bara.T))
        # Recombine shards with scatter-into-zeros + psum instead of a
        # tiled all_gather: the slices are disjoint so the sum IS the
        # concatenation, and psum's output is statically known to be
        # replicated over sp — jax 0.9's shard_map VMA check cannot
        # infer that for an all_gather of axis_index-dependent slices
        # (it rejected out_specs=P('dp', None) at trace time).
        acc_full = jnp.zeros((lwe.shape[0], p.k + 1, p.N), jnp.int32)
        acc_full = jax.lax.dynamic_update_slice_in_dim(
            acc_full, acc_local, start, axis=2
        )
        acc = jax.lax.psum(acc_full, "sp")
        ext = sample_extract(acc, p)
        # keyswitch replicated across sp (one small matmul)
        from ieache.ops.keyswitch import keyswitch

        return keyswitch(ext, ks_limbs, p)

    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("dp", None), P(), P()),
        out_specs=P("dp", None),
    )
    return jax.jit(mapped)


def shard_cloud_key(dck: DeviceCloudKey, mesh: Mesh):
    """Place bk/ks_limbs with their tp shardings (dp-replicated)."""
    bk = jax.device_put(
        dck.bk, NamedSharding(mesh, P(None, "tp", None, None))
    )
    ks = jax.device_put(
        dck.ks_limbs, NamedSharding(mesh, P(None, "tp", None))
    )
    return bk, ks


def shard_batch(lwe, mesh: Mesh):
    return jax.device_put(lwe, NamedSharding(mesh, P("dp", None)))
