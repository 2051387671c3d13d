#!/usr/bin/env python
"""Time the full bootstrap pipeline at lambda=110 scale on the device."""

import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ieache import params as P
import ieache.boot.bootstrap as boot
from ieache.boot import gates
from ieache.lwe.types import CloudKeySet
from ieache.utils.cache import enable_compile_cache

enable_compile_cache()

p = P.IEACHE_110
B = int(os.environ.get("B", 512))
rng = np.random.RandomState(0)


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


log("building random (structurally valid) keys...")
bk = rng.randint(-2**31, 2**31,
                 (p.n, p.trgsw_rows, p.k + 1, p.N)).astype(np.int32)
ks = rng.randint(-2**31, 2**31, (p.kN * p.ks_t, p.n + 1)).astype(np.int32)
log("packing to device...")
dck = boot.pack_cloud_key(CloudKeySet(p, bk, ks))
jax.block_until_ready(dck.bk)
jax.block_until_ready(dck.ks_limbs)
log("packed")

lwe = jnp.asarray(rng.randint(-2**31, 2**31, (B, p.n + 1)).astype(np.int32))

log("compiling bootstrap...")
t0 = time.time()
out = boot.bootstrap(lwe, dck)
jax.block_until_ready(out)
log(f"compile+first run: {time.time() - t0:.1f}s")

iters = 3
t0 = time.time()
for _ in range(iters):
    out = boot.bootstrap(lwe, dck)
jax.block_until_ready(out)
dt = (time.time() - t0) / iters
log(f"steady state: {dt*1e3:.1f} ms/batch -> {B/dt:.1f} bootstraps/s")
