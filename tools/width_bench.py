#!/usr/bin/env python
"""Reference-width arithmetic on hardware: mul32/64/128 + 256-bit add.

Runs the reference's heaviest capabilities (`Cloud/cloud.c:115-218`
mul32, `:220-385` mul64, `:387-647` mul128, 8-limb add
`cloud.c:1109-1116`) through the full CloudEvaluator at full lambda=110
parameters, verifies every decryption, and prints one JSON line per
configuration.

Batch sizes are chosen so the CSA compress waves are ~1024 bootstrap
lanes (B*2W).

Env: WB_PARAMS (ieache_110_l2|ieache_110|test_tiny), WB_CASES
(comma list from mul32,mul64,mul128,add256), WB_FORCE_CPU=1.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


CASES = {
    # name: (op, width, batch)
    # mul32 at B=32 reaches the b*(W+1) = 1056-lane class of the
    # windowed CSA multiplier
    "mul32": ("mul", 32, 32),
    "mul64": ("mul", 64, 8),
    "mul128": ("mul", 128, 4),
    # 256-bit operands are ~0.5 MB/lane of ciphertext; B=256 keeps the
    # whole flow (2 operands + selects + adder scan stack) well inside
    # device memory
    "add256": ("add", 256, 256),
}


def main():
    if os.environ.get("WB_FORCE_CPU"):
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    from ieache.utils.cache import enable_compile_cache

    enable_compile_cache()
    from ieache import params as P
    from ieache.codec import files
    import ieache.boot.bootstrap as boot
    from ieache.circuits import evaluator as ev
    from ieache.lwe import keygen
    from ieache.utils import prng

    pname = os.environ.get("WB_PARAMS", "ieache_110_l2")
    p = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
         "test_tiny": P.TEST_TINY}[pname]
    names = os.environ.get("WB_CASES", "mul32,mul64,mul128,add256")

    cache = os.path.join(os.path.dirname(__file__), "..", ".keycache")
    os.makedirs(cache, exist_ok=True)

    def keyset(seed, tag):
        path = os.path.join(cache, f"{p.name}{tag}.iek")
        if os.path.exists(path):
            return files.load_secret_keyset(path)
        ks = keygen.generate_secret_keyset(p, seed)
        files.save_secret_keyset(path, ks)
        return ks

    main_ks = keyset(keygen.MAIN_SEED, "")
    nbit_ks = keyset(keygen.NBIT_SEED, "_nbit")
    dck = boot.pack_cloud_key(main_ks.cloud)
    cloud = ev.CloudEvaluator(dck, nbit_ks)
    rng = np.random.RandomState(7)

    def rand_vals(width, batch):
        # random signed magnitudes spanning the full width
        out = []
        for _ in range(batch):
            v = int(rng.randint(1, 2 ** 31))
            for _ in range((width - 1) // 31):
                v = (v << 31) | int(rng.randint(0, 2 ** 31))
            v &= (1 << width) - 1
            v = max(v, 1)
            out.append(-v if rng.rand() < 0.5 else v)
        return out

    for name in names.split(","):
        op_kind, width, batch = CASES[name]
        a_vals = rand_vals(width, batch)
        b_vals = rand_vals(width, batch)
        op = ev.OP_MUL if op_kind == "mul" else ev.OP_ADD
        if op_kind == "add":
            # magnitude adds must fit the operand width
            a_vals = [abs(v) >> 1 for v in a_vals]
            b_vals = [abs(v) >> 1 for v in b_vals]
            want = [x + y for x, y in zip(a_vals, b_vals)]
        else:
            want = [x * y for x, y in zip(a_vals, b_vals)]

        s = prng.key_from_seed_words([0xB0B, width, batch])
        t0 = time.time()
        a = ev.encrypt_operand(main_ks, nbit_ks, a_vals, width,
                               prng.derive(s, 0))
        b = ev.encrypt_operand(main_ks, nbit_ks, b_vals, width,
                               prng.derive(s, 1))
        t_enc = time.time() - t0

        gates0 = cloud.gate_count
        t0 = time.time()
        ans, info = cloud.compute(op, a, b)
        got = ev.decrypt_answer(main_ks, nbit_ks, ans, op)
        cold = time.time() - t0
        gates = cloud.gate_count - gates0
        errors = sum(1 for g, w in zip(got, want) if g != w)

        # warm pass = steady-state rate (compiles cached)
        t0 = time.time()
        ans, _ = cloud.compute(op, a, b)
        got = ev.decrypt_answer(main_ks, nbit_ks, ans, op)
        warm = time.time() - t0
        errors += sum(1 for g, w in zip(got, want) if g != w)

        print(json.dumps({
            "case": name,
            "op": op_kind,
            "width": width,
            "batch": batch,
            "gates_per_pass": gates,
            "bootstraps_per_sec": round(gates / warm, 1),
            "seconds_warm": round(warm, 2),
            "seconds_cold_incl_compile": round(cold, 2),
            "seconds_encrypt": round(t_enc, 2),
            "errors": errors,
            "params": p.name,
            "mul_mode": os.environ.get("IEACHE_MUL", "csa"),
            "device": jax.devices()[0].device_kind,
        }), flush=True)


if __name__ == "__main__":
    main()
