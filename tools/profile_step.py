#!/usr/bin/env python
"""Profile the blind-rotation step components at full scale on the device."""

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ieache import params as P
from ieache.core.poly import (
    TORUS_LIMBS, _dot_i8, _toeplitz_from_extended, negacyclic_extend,
    split_i8_limbs,
)
from ieache.ops import blind_rotate as br
from ieache.ops.decompose import gadget_decompose
from ieache.utils.cache import enable_compile_cache

enable_compile_cache()

p = P.IEACHE_110
B = int(os.environ.get("B", 512))
STEPS = int(os.environ.get("STEPS", 20))
rows, kp1, N = p.trgsw_rows, p.k + 1, p.N

rng = np.random.RandomState(0)
acc = jnp.asarray(rng.randint(-2**31, 2**31, (B, kp1, N)).astype(np.int32))
bara = jnp.asarray(rng.randint(0, 2 * N, (B,)).astype(np.int32))
bk_i = jnp.asarray(
    rng.randint(-2**31, 2**31, (rows, kp1, N)).astype(np.int32)
)
d8 = jnp.asarray(rng.randint(-128, 128, (B, rows * N)).astype(np.int8))
g = jnp.asarray(
    rng.randint(-128, 128, (TORUS_LIMBS, rows * N, kp1 * N)).astype(np.int8)
)


def timeit(name, fn, *args, iters=3):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"{name:30s} {dt*1e3:10.2f} ms")
    return dt


@jax.jit
def rot_dec(acc, bara):
    return jnp.sum(br._step_digits(acc, bara, p))


@jax.jit
def build_g(bk_i):
    return jnp.sum(br.make_step_gmatrix(bk_i, p).astype(jnp.int32))


@jax.jit
def matmuls(d8, g):
    out = jnp.zeros((B, kp1 * N), jnp.int32)
    for v in range(TORUS_LIMBS):
        out = out + (_dot_i8(d8, g[v]) << (8 * v))
    return jnp.sum(out)


@jax.jit
def full_step(acc, bara, bk_i):
    return jnp.sum(br.external_product_step(acc, bara, bk_i, p))


print(f"B={B} rows={rows} N={N}  device={jax.devices()[0]}")
t_rot = timeit("rotate+decompose", rot_dec, acc, bara)
t_g = timeit("G build", build_g, bk_i)
t_mm = timeit("4x int8 matmul", matmuls, d8, g)
t_step = timeit("full step", full_step, acc, bara, bk_i)
print(f"-> {p.n} steps => {p.n * t_step:.2f} s/bootstrap-batch "
      f"({B / (p.n * t_step):.1f} bootstraps/s)")
