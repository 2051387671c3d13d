#!/usr/bin/env python
"""Batched end-to-end expression benchmark (BASELINE configs 2-5).

Evaluates B parallel 3-operand 16-bit expressions A+B-C (the
reference's headline `A+B-C` case: 149 s for ONE expression on its
6-VM deployment, AC058.pdf Fig.7) through the full evaluator
(metadata, sign dispatch, two ripple adds + two's complement) and
verifies every decryption.

Env: EB_BATCH (default 256), EB_WIDTH (16), EB_PARAMS (ieache_110),
EB_ADDER (ripple|kogge_stone), EB_EXPR (one of the six Fig.7 cases:
add_add=A+B+C, add_sub=A+B-C, sub_sub=A-B-C, mul_add=A+B*C,
add_mul=A-B*C, mul_mul=A*B*C),
EB_DP (default = all devices: shard the batch over a dp mesh —
EB_BATCH=4096 EB_DP=N is BASELINE config 5, the 4096-expression
batched multi-chip run; requires dp | batch).
Prints one JSON line with expressions/s, bootstraps/s, and per-
expression latency-equivalents.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    if os.environ.get("EB_FORCE_CPU"):
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
    from ieache import params as P
    from ieache.codec import files
    import ieache.boot.bootstrap as boot
    from ieache.circuits import evaluator as ev
    from ieache.lwe import keygen
    from ieache.utils import prng

    pname = os.environ.get("EB_PARAMS", "ieache_110")
    p = {"ieache_110": P.IEACHE_110, "ieache_110_l2": P.IEACHE_110_FAST,
         "test_tiny": P.TEST_TINY,
         "test_small_noisy": P.TEST_SMALL_NOISY}[pname]
    batch = int(os.environ.get("EB_BATCH", 256))
    width = int(os.environ.get("EB_WIDTH", 16))
    adder = os.environ.get("EB_ADDER", "ripple")
    expr = os.environ.get("EB_EXPR", "add_sub")

    cache = os.path.join(os.path.dirname(__file__), "..", ".keycache")
    os.makedirs(cache, exist_ok=True)

    def keyset(seed, tag):
        path = os.path.join(cache, f"{p.name}_{tag}.iek")
        if os.path.exists(path):
            return files.load_secret_keyset(path)
        ks = keygen.generate_secret_keyset(p, seed)
        files.save_secret_keyset(path, ks)
        return ks

    main_ks = keyset(keygen.MAIN_SEED, "")
    nbit_ks = keyset(keygen.NBIT_SEED, "nbit")
    # reuse the main cache name for bench.py compat
    dck = boot.pack_cloud_key(main_ks.cloud)

    dp = int(os.environ.get("EB_DP", min(len(jax.devices()), batch)))
    mesh = None
    if dp > 1:
        from ieache.dist import batch as dbatch, mesh as dmesh

        mesh = dmesh.make_mesh(dp, tp=1)
        dck = dbatch.replicate_cloud_key(dck, mesh)
    cloud = ev.CloudEvaluator(dck, nbit_ks, adder=adder)

    rng = np.random.RandomState(0)
    hi = 1 << (width - 2)
    a_vals = rng.randint(1, hi, batch)
    b_vals = rng.randint(1, hi, batch)
    c_vals = rng.randint(1, hi, batch)

    stream = prng.key_from_seed_words([0xE1, batch, width])
    enc = lambda vals, i: ev.encrypt_operand(  # noqa: E731
        main_ks, nbit_ks, vals, width, prng.derive(stream, i)
    )
    t_enc0 = time.time()
    a = enc(a_vals, 0)
    b = enc(b_vals, 1)
    c = enc(c_vals, 2)
    if mesh is not None:
        from ieache.dist import batch as dbatch

        a, b, c = (dbatch.shard_operand(x, mesh) for x in (a, b, c))
    t_enc = time.time() - t_enc0

    # EB_CHAIN=1 (default): left-fold expressions run as ONE compiled
    # circuit (compute_chain); EB_CHAIN=0 = per-op dispatches
    use_chain = os.environ.get("EB_CHAIN", "1") != "0"

    # EB_CHUNK: evaluate the batch as sequential passes of this many
    # lanes (off by default: one pass over the whole batch).
    chunk = int(os.environ.get("EB_CHUNK", 0))
    if chunk and batch % chunk:
        raise SystemExit(f"EB_CHUNK {chunk} must divide batch {batch}")
    n_chunks = (batch // chunk) if chunk else 1

    def _slice_op(o, lo, hi):
        return ev.Operand(o.neg_word[lo:hi], o.bit_word[lo:hi],
                          o.value[lo:hi], o.carry_word[lo:hi])

    # The six expressions of the reference paper's Fig.7 benchmark
    # (AC058.pdf p.4; BASELINE.md "Published numbers").  Left folds
    # run via compute_chain; the mul-first trees (ABC*+ / ABC*-, the
    # shapes the reference CLI actually produces) via compute_steps.
    # Values: (display, left-fold ops or None, step list or None,
    # plaintext lambda, reference seconds/expr).
    FIG7 = {
        "add_add": ("A+B+C", [ev.OP_ADD, ev.OP_ADD], None,
                    lambda x, y, z: x + y + z, 142.0),
        "add_sub": ("A+B-C", [ev.OP_ADD, ev.OP_SUB], None,
                    lambda x, y, z: x + y - z, 149.0),
        "sub_sub": ("A-B-C", [ev.OP_SUB, ev.OP_SUB], None,
                    lambda x, y, z: x - y - z, 159.0),
        "mul_add": ("A+B*C", None,
                    [(ev.OP_MUL, ("opnd", 1), ("opnd", 2)),
                     (ev.OP_ADD, ("opnd", 0), ("step", 0))],
                    lambda x, y, z: x + y * z, 329.0),
        "add_mul": ("A-B*C", None,
                    [(ev.OP_MUL, ("opnd", 1), ("opnd", 2)),
                     (ev.OP_SUB, ("opnd", 0), ("step", 0))],
                    lambda x, y, z: x - y * z, 359.0),
        "mul_mul": ("A*B*C", [ev.OP_MUL, ev.OP_MUL], None,
                    lambda x, y, z: x * y * z, 563.0),
    }
    if expr not in FIG7:
        raise SystemExit(f"EB_EXPR must be one of {sorted(FIG7)}")
    disp, fold_ops, step_list, plain, ref_s = FIG7[expr]

    def run_expr(ai, bi, ci, av, bv, cv):
        want = [plain(int(x), int(y), int(z))
                for x, y, z in zip(av, bv, cv)]
        if fold_ops is not None:
            if use_chain:
                ans, _ = cloud.compute_chain(fold_ops, [ai, bi, ci])
            else:
                ab, _ = cloud.compute(fold_ops[0], ai, bi)
                ans, _ = cloud.compute(fold_ops[1], ab, ci)
            return ans, want, fold_ops[-1]
        if use_chain:
            ans, _ = cloud.compute_steps(step_list, [ai, bi, ci])
        else:
            bc, _ = cloud.compute(ev.OP_MUL, bi, ci)
            ans, _ = cloud.compute(step_list[-1][0], ai, bc)
        return ans, want, step_list[-1][0]

    def one_pass():
        """All chunks through compute + decrypt; returns (got, want)."""
        gots, wants = [], []
        for j in range(n_chunks):
            lo = j * chunk if chunk else 0
            hi = lo + chunk if chunk else batch
            ai, bi, ci = (_slice_op(x, lo, hi) for x in (a, b, c))
            ans, want, fop = run_expr(
                ai, bi, ci, a_vals[lo:hi], b_vals[lo:hi],
                c_vals[lo:hi]
            )
            gots += ev.decrypt_answer(main_ks, nbit_ks, ans, fop)
            wants += want
        return gots, wants

    # EB_COMPILE_ONLY=1: AOT-compile the chain and print XLA's device
    # memory accounting WITHOUT executing — the audit for shapes that
    # may not fit the card
    if os.environ.get("EB_COMPILE_ONLY") == "1":
        lo_, hi_ = (0, chunk) if chunk else (0, batch)
        ai, bi, ci = (_slice_op(x, lo_, hi_) for x in (a, b, c))
        ops_steps = (
            [(op, ("opnd", 0) if k == 0 else ("step", k - 1),
              ("opnd", k + 1)) for k, op in enumerate(fold_ops)]
            if fold_ops is not None else step_list
        )
        t0 = time.time()
        ma = cloud.chain_memory_analysis(ops_steps, [ai, bi, ci])
        print(json.dumps({
            "metric": "chain_memory_analysis",
            "expr": disp, "batch": hi_ - lo_, "width": width,
            "params": p.name, "device": jax.devices()[0].device_kind,
            "compile_s": round(time.time() - t0, 1),
            **ma,
            "temp_gb": round(ma["temp_size_in_bytes"] / 2**30, 3),
        }))
        return

    # cold pass (includes jit compiles), then a warm pass = the
    # steady-state serving rate
    t0 = time.time()
    got, want = one_pass()
    cold = time.time() - t0
    errors = sum(1 for g, w in zip(got, want) if g != w)
    gates = cloud.gate_count

    t0 = time.time()
    got, want = one_pass()
    warm = time.time() - t0
    errors += sum(1 for g, w in zip(got, want) if g != w)

    out = {
        "metric": "expressions_per_sec",
        "value": round(batch / warm, 3),
        "unit": "expr/s",
        "expr": disp,
        "batch": batch,
        "width": width,
        "adder": adder,
        "chained": use_chain,
        "seconds_warm": round(warm, 2),
        "seconds_cold_incl_compile": round(cold, 2),
        "seconds_encrypt": round(t_enc, 2),
        "bootstraps_per_sec": round(gates / warm, 1),
        "gates_per_pass": gates,
        "errors": errors,
        "vs_reference_s_per_expr": round((batch / warm) * ref_s, 1),
        "reference_s_per_expr": ref_s,
        "dp": dp,
        "chunk": chunk or batch,
        "params": p.name,
        "device": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
