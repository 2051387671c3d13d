#!/usr/bin/env python
"""Empirical noise-margin probe at full parameters on real hardware.

Bootstraps a batch of XOR gates (the worst-case 2x linear combination
at the NEXT gate's input) and measures the output phase-error
distribution against the 1/16-torus failure threshold.  This is the
hardware validation for parameter changes that trade decomposition
precision for throughput (params.IEACHE_110_FAST).

Prints one JSON line: measured sigma (torus fraction), the sigma
margin to the threshold under a 2x combo, and decrypt errors.

Env: MP_PARAMS (ieache_110 | ieache_110_l2 | test_small_noisy),
MP_BATCH (2048), MP_ROUNDS (4: chains XOR->NAND to also stress
accumulated noise).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax
    import jax.numpy as jnp

    from ieache import params as P
    import ieache.boot.bootstrap as boot
    from ieache.boot import gates
    from ieache.codec import files
    from ieache.lwe import encrypt, keygen
    from ieache.utils import prng
    from ieache.utils.cache import enable_compile_cache

    enable_compile_cache()
    pname = os.environ.get("MP_PARAMS", "ieache_110_l2")
    p = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
         "test_small_noisy": P.TEST_SMALL_NOISY}[pname]
    batch = int(os.environ.get("MP_BATCH", 2048))
    rounds = int(os.environ.get("MP_ROUNDS", 4))

    cache = os.path.join(os.path.dirname(__file__), "..", ".keycache")
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, f"{p.name}.iek")
    if os.path.exists(path):
        ks = files.load_secret_keyset(path)
    else:
        t0 = time.time()
        ks = keygen.generate_secret_keyset(p)
        print(f"# keygen: {time.time() - t0:.1f}s", file=sys.stderr)
        files.save_secret_keyset(path, ks)
    dck = boot.pack_cloud_key(ks.cloud)

    stream = prng.key_from_seed_words([0x3A6])
    xb = prng.uniform_bits01(prng.derive(stream, 0), batch)
    yb = prng.uniform_bits01(prng.derive(stream, 1), batch)
    cx = jnp.asarray(encrypt.encrypt_bits(ks, xb, prng.derive(stream, 2)))
    cy = jnp.asarray(encrypt.encrypt_bits(ks, yb, prng.derive(stream, 3)))

    mu = boot.MU
    errors = 0
    sigmas = []
    want = xb ^ yb
    out = gates.XOR(cx, cy, dck)
    for r in range(rounds):
        out_h = np.asarray(out)
        ph = encrypt.phase_of(ks, out_h).astype(np.float64)
        err = np.where(want == 1, ph - mu, ph + mu)
        sigmas.append(float(err.std()))
        errors += int((encrypt.decrypt_bits(ks, out_h) != want).sum())
        if r + 1 < rounds:  # keep chaining: out XOR cy, NAND refresh
            want = want ^ yb
            out = gates.XOR(out, cy, dck)

    sigma = max(sigmas)
    threshold = 2**32 / 16
    # worst-case next-gate input doubles the noise (XOR = 2x - 2y combo
    # sums two independent outputs: stdev * sqrt(2) * 2 in the combo
    # 2(x - y); use the conservative 2*sqrt(2) factor)
    margin_sigma = threshold / (2 * np.sqrt(2) * sigma)
    print(json.dumps({
        "metric": "phase_noise_margin",
        "value": round(float(margin_sigma), 2),
        "unit": "sigma",
        "sigma_torus": round(sigma / 2**32, 6),
        "sigmas_per_round": [round(s / 2**32, 6) for s in sigmas],
        "batch": batch,
        "rounds": rounds,
        "errors": errors,
        "params": p.name,
        "platform": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
