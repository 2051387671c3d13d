#!/usr/bin/env python
"""Multi-host worker: dp-sharded gate evaluation across OS processes.

One process per "host", joined through ``jax.distributed`` (the
Replacement for the reference's six-host TCP topology,
SURVEY §5.8).  Each host encrypts its local slice of the gate batch,
the slices form ONE global dp-sharded array over all hosts' devices,
the batched AND gate runs SPMD (cross-host collectives over
gloo/DCN), and each host decrypts + verifies its own shard.

Usage (run once per process):
    python tools/multihost_demo.py <process_id> <num_processes> <port>
Env: MH_LOCAL_DEVICES (virtual CPU devices per process, default 2),
MH_BATCH (global batch, default 16).

`tests/test_multihost.py` drives two of these and asserts both verify.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    ndev = int(os.environ.get("MH_LOCAL_DEVICES", 2))
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={ndev}"
    ).strip()

    from ieache.dist import multihost

    multihost.initialize(f"127.0.0.1:{port}", nproc, pid,
                         platform="cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    import ieache.boot.bootstrap as boot
    from ieache.boot import gates
    from ieache import params as P
    from ieache.lwe import encrypt, keygen
    from ieache.utils import prng

    batch = int(os.environ.get("MH_BATCH", 16))
    assert batch % (nproc * ndev) == 0
    local = batch // nproc

    # deterministic keygen -> every host derives the SAME keys (the
    # reference fans the key files out over TCP, C15/C16; here the
    # fan-out is replication of the packed key into the global mesh)
    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    mesh = multihost.global_mesh(tp=1)
    dck = multihost.replicate_cloud_key(boot.pack_cloud_key(ks.cloud),
                                        mesh)

    stream = prng.key_from_seed_words([0x34, batch])
    xbits = prng.uniform_bits01(prng.derive(stream, 0), batch)
    ybits = prng.uniform_bits01(prng.derive(stream, 1), batch)
    xct = encrypt.encrypt_bits(ks, xbits, prng.derive(stream, 2))
    yct = encrypt.encrypt_bits(ks, ybits, prng.derive(stream, 3))
    sl = slice(pid * local, (pid + 1) * local)
    gx = multihost.shard_global_batch(jnp.asarray(xct[sl]), mesh)
    gy = multihost.shard_global_batch(jnp.asarray(yct[sl]), mesh)

    @jax.jit
    def and_gate(a, b):
        return gates.AND(a, b, dck)

    gout = and_gate(gx, gy)
    local_out = np.asarray(multihost.to_host_local(gout, mesh))
    got = encrypt.decrypt_bits(ks, local_out)
    want = (np.asarray(xbits) & np.asarray(ybits))[sl]
    errors = int(np.sum(np.asarray(got) != want))
    print(f"MH_OK pid={pid} devices={len(jax.devices())} "
          f"local={local} errors={errors}", flush=True)
    sys.exit(0 if errors == 0 else 1)


if __name__ == "__main__":
    main()
