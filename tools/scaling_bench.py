#!/usr/bin/env python
"""Scaling-efficiency benchmark: bootstraps/s at dp = 1, 2, ..., N.

The per-gate work is embarrassingly batch-parallel (each gate bootstrap is
independent, like the reference's multi-client fan-out), so the only
scaling losses are dispatch overhead and key replication.

Runs on whatever devices JAX exposes: all cards of a GPU host, or a
virtual CPU mesh (SB_FORCE_CPU=1 sets 8 virtual devices — numbers are
then not device numbers; the virtual devices share the same cores).

Prints one JSON line per dp size plus a summary line with the
efficiency at max dp.  Env: SB_PARAMS (test_tiny|test_small_noisy|
ieache_110), SB_BATCH_PER_CHIP (default 256), SB_ITERS (4), SB_TP (1),
SB_TP_CHUNKS (2 — the r5 batch-pipelined psum overlap).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    if os.environ.get("SB_FORCE_CPU"):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    from ieache.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    from ieache import params as P
    from ieache.boot import gates
    import ieache.boot.bootstrap as boot
    from ieache.dist import batch as dbatch, mesh as dmesh
    from ieache.dist import shard as dshard
    from ieache.lwe import encrypt, keygen
    from ieache.utils import prng
    from ieache.codec import files

    pname = os.environ.get("SB_PARAMS", "test_small_noisy")
    p = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
         "test_tiny": P.TEST_TINY,
         "test_small_noisy": P.TEST_SMALL_NOISY}[pname]
    per_chip = int(os.environ.get("SB_BATCH_PER_CHIP", 256))
    iters = int(os.environ.get("SB_ITERS", 4))
    tp = int(os.environ.get("SB_TP", 1))
    sp = int(os.environ.get("SB_SP", 1))
    if tp > 1 and sp > 1:
        sys.exit("SB_TP and SB_SP are mutually exclusive")

    cache = os.path.join(os.path.dirname(__file__), "..", ".keycache")
    os.makedirs(cache, exist_ok=True)
    key_path = os.path.join(cache, f"{p.name}.iek")
    if os.path.exists(key_path):
        ks = files.load_secret_keyset(key_path)
    else:
        ks = keygen.generate_secret_keyset(p)
        files.save_secret_keyset(key_path, ks)
    dck = boot.pack_cloud_key(ks.cloud)

    n_dev = len(jax.devices())
    model = tp * sp
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d * model <= n_dev]
    stream = prng.key_from_seed_words([0x5CA1E])
    rates = {}
    for dp in sizes:
        if sp > 1:
            m = dshard.make_sp_mesh(dp * sp, sp=sp)
        else:
            m = dmesh.make_mesh(dp * tp, tp=tp)
        batch = per_chip * dp
        xb = prng.uniform_bits01(prng.derive(stream, 2 * dp), batch)
        yb = prng.uniform_bits01(prng.derive(stream, 2 * dp + 1), batch)
        from jax.sharding import NamedSharding, PartitionSpec as Pt

        sh = NamedSharding(m, Pt("dp", None))
        cx = jax.device_put(jnp.asarray(
            encrypt.encrypt_bits(ks, xb, prng.derive(stream, 100 + dp))), sh)
        cy = jax.device_put(jnp.asarray(
            encrypt.encrypt_bits(ks, yb, prng.derive(stream, 200 + dp))), sh)

        if sp > 1:
            # sp engages the polynomial-axis-sharded pipeline
            # (dist/shard.make_sharded_bootstrap_sp): one all_gather
            # per blind-rotation step, keys replicated.
            boot_fn = dshard.make_sharded_bootstrap_sp(m, p)

            def run():
                pre = -cx - cy
                pre = pre.at[:, p.n].add(boot.MU)
                return boot_fn(pre, dck.bk, dck.ks_limbs)
        elif tp > 1:
            # tp engages the sharded-contraction pipeline (dist/shard.py):
            # bk/ks sharded over tp, one psum per blind-rotation step.
            boot_fn = dshard.make_sharded_bootstrap(
                m, p, overlap_chunks=int(
                    os.environ.get("SB_TP_CHUNKS", 2)))
            bk, ksl = dshard.shard_cloud_key(dck, m)

            def run():
                pre = -cx - cy
                pre = pre.at[:, p.n].add(boot.MU)
                return boot_fn(pre, bk, ksl)
        else:
            dck_r = dbatch.replicate_cloud_key(dck, m)

            def run():
                return gates.NAND(cx, cy, dck_r)

        out = run()  # compile + warmup
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run()
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        out_h = np.asarray(out)

        errors = int(
            (encrypt.decrypt_bits(ks, out_h) != (1 - (xb & yb))).sum()
        )
        rate = batch * iters / dt
        rates[dp] = rate
        print(json.dumps({
            "metric": "scaling_bootstraps_per_sec",
            "dp": dp, "tp": tp, "sp": sp, "batch": batch,
            "value": round(rate, 1), "unit": "bootstraps/s",
            "seconds": round(dt, 3), "errors": errors,
        }))

    base = rates[sizes[0]]
    top = sizes[-1]
    eff = rates[top] / (base * top / sizes[0])
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": round(eff, 4),
        "unit": "fraction",
        "dp_max": top,
        "params": p.name,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
