#!/usr/bin/env python
"""Headline benchmark: TFHE gate bootstraps/sec/chip.

Prints ONE JSON line:
    {"metric": "gate_bootstraps_per_sec_per_chip", "value": N,
     "unit": "bootstraps/s", "vs_baseline": R}

Baseline: the reference's tfhe-spqlios core sustains ~40 gate
bootstraps/sec/core (BASELINE.md: A*B*C = 22.6k bootstraps in 563 s on
the paper's i7 VM), so vs_baseline = value / 40.

Runs on the GPU and exits non-zero without one; BENCH_FORCE_CPU=1 is
the explicit opt-in for a CPU smoke run (whose times are not device
numbers).  Full lambda=110 parameters; keyset cached on disk after
first generation.  Env overrides: BENCH_BATCH, BENCH_ITERS,
BENCH_PARAMS=tiny for a smoke run.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    from ieache.utils.cache import enable_compile_cache

    if os.environ.get("BENCH_FORCE_CPU"):
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU, found {jax.devices()[0].platform}"
                 " (BENCH_FORCE_CPU=1 for a CPU smoke run)")
    enable_compile_cache()
    import jax.numpy as jnp

    from ieache import params as P
    import ieache.boot.bootstrap as boot
    from ieache.boot import gates
    from ieache.lwe import encrypt, keygen
    from ieache.utils import prng

    pname = os.environ.get("BENCH_PARAMS", "fast")
    if pname == "tiny":
        p = P.TEST_TINY
        batch = int(os.environ.get("BENCH_BATCH", 64))
    else:
        # "fast" (default) = IEACHE_110_FAST: same lambda=110 security
        # sizes/noise as IEACHE_110, gadget (8,2) instead of (8,3) ->
        # 1/3 less matmul work; margin validated by tools/margin_probe.py.
        choices = {"fast": P.IEACHE_110_FAST, "l3": P.IEACHE_110,
                   "ieache_110": P.IEACHE_110}
        if pname not in choices:
            sys.exit(f"BENCH_PARAMS must be one of "
                     f"{['tiny', *choices]}, got {pname!r}")
        p = choices[pname]
        batch = int(os.environ.get("BENCH_BATCH", 1024))
    iters = int(os.environ.get("BENCH_ITERS", 16))

    ks = keygen.cached_keyset(
        p, keygen.MAIN_SEED,
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".keycache", f"{p.name}_.iek"))
    dck = boot.pack_cloud_key(ks.cloud)

    # batch of NAND gates over random bits
    stream = prng.key_from_seed_words([2026])
    xbits = prng.uniform_bits01(prng.derive(stream, 0), batch)
    ybits = prng.uniform_bits01(prng.derive(stream, 1), batch)
    cx = jnp.asarray(encrypt.encrypt_bits(ks, xbits, prng.derive(stream, 2)))
    cy = jnp.asarray(encrypt.encrypt_bits(ks, ybits, prng.derive(stream, 3)))

    jax.block_until_ready(gates.NAND(cx, cy, dck))  # compile + warmup

    t0 = time.perf_counter()
    for _ in range(iters):
        out = gates.NAND(cx, cy, dck)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    out_host = np.asarray(out)

    got = encrypt.decrypt_bits(ks, out_host)
    want = 1 - (xbits & ybits)
    errors = int((got != want).sum())

    value = batch * iters / dt
    result = {
        "metric": "gate_bootstraps_per_sec_per_chip",
        "value": round(value, 2),
        "unit": "bootstraps/s",
        "vs_baseline": round(value / 40.0, 2),
        "batch": batch,
        "iters": iters,
        "seconds": round(dt, 3),
        "decrypt_errors": errors,
        "params": p.name,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
