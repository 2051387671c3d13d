#!/usr/bin/env python
"""Per-component cost inside a fused scan (amortizes dispatch overhead)."""

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ieache import params as P
from ieache.core.poly import TORUS_LIMBS
from ieache.ops import blind_rotate as br
from ieache.utils.cache import enable_compile_cache

enable_compile_cache()

p = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST}[
    os.environ.get("PARAMS", "ieache_110_l2")]
B = int(os.environ.get("B", 512))
STEPS = int(os.environ.get("STEPS", 50))
rows, kp1, N = p.trgsw_rows, p.k + 1, p.N
K = rows * N

rng = np.random.RandomState(0)
acc0 = jnp.asarray(rng.randint(-2**31, 2**31, (B, kp1, N)).astype(np.int32))
bara = jnp.asarray(rng.randint(0, 2 * N, (STEPS, B)).astype(np.int32))
bks = jnp.asarray(
    rng.randint(-2**31, 2**31, (STEPS, rows, kp1, N)).astype(np.int32)
)
d8 = jnp.asarray(rng.randint(-128, 128, (B, rows, N)).astype(np.int8))
g0 = jnp.asarray(
    rng.randint(-128, 128, (TORUS_LIMBS, rows, kp1, N, N)).astype(np.int8)
)


def bench(name, jfn, *args, iters=2):
    jax.block_until_ready(jfn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jfn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters / STEPS
    print(f"{name:28s} {dt*1e3:8.3f} ms/step", flush=True)
    return dt


@jax.jit
def scan_rot(acc0, bara):
    def step(acc, bara_i):
        d = br._step_digits(acc, bara_i, p)
        acc = acc + d[:, :kp1, :]  # force dependency
        return acc, None
    acc, _ = jax.lax.scan(step, acc0, bara)
    return jnp.sum(acc)


@jax.jit
def scan_build(bks, acc0):
    def step(carry, bk_i):
        g = br.make_step_gmatrix(bk_i, p)
        carry = carry + jnp.sum(g.astype(jnp.int32))
        return carry, None
    c, _ = jax.lax.scan(step, jnp.int32(0), bks)
    return c


@jax.jit
def scan_matmul(d8, g0, acc0):
    def step(acc, _):
        out = jnp.zeros((B, kp1, N), jnp.int32)
        for v in range(TORUS_LIMBS):
            out = out + (br._dot_digits_g(d8, g0[v]) << (8 * v))
        acc = acc + out
        return acc, None
    acc, _ = jax.lax.scan(step, acc0, None, length=STEPS)
    return jnp.sum(acc)


@jax.jit
def scan_kernel(d8, bks, acc0):
    """The Hopper external-product kernel only (digits held fixed)."""
    from ieache.ops.pallas_kernels import external_product

    def step(acc, bk_i):
        acc = acc + external_product(d8, bk_i, p)
        return acc, None
    acc, _ = jax.lax.scan(step, acc0, bks)
    return jnp.sum(acc)


@jax.jit
def scan_full(acc0, bara, bks):
    def step(acc, xs):
        bk_i, bara_i = xs
        return br.external_product_step(acc, bara_i, bk_i, p), None
    acc, _ = jax.lax.scan(step, acc0, (bks, bara))
    return jnp.sum(acc)


print(f"B={B} STEPS={STEPS} params={p.name}", flush=True)
bench("scan: rotate+decompose", scan_rot, acc0, bara)
if os.environ.get("XLA_PARTS"):
    bench("scan: G build", scan_build, bks, acc0)
    bench("scan: matmuls only", scan_matmul, d8, g0, acc0)
if jax.default_backend() == "gpu":
    bench("scan: kernel ext-product", scan_kernel, d8, bks, acc0)
t = bench("scan: full step", scan_full, acc0, bara, bks)
print(f"-> projected {B/(p.n*t):.1f} bootstraps/s at B={B}")
