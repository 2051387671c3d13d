#!/usr/bin/env python
"""Smoke test of the whole system on one NVIDIA GPU.

Runs the λ=110 main path once, through the entry points a user calls,
and checks every result:

1. device: the card's name and power limit (nvidia-smi) and JAX's kind;
2. keys: the ieache_110 (l=3) and ieache_110_l2 keysets, loaded from or
   generated into .keycache/, and uploaded;
3. oracle parity: ``boot.bootstrap`` on 4 lanes per keyset against the
   C++ oracle, 0 differing words; no float matmul on the step;
4. kernel parity and timing: the Hopper external-product kernel against
   the plain XLA step over 500-step scans with the real keys, bit for
   bit, at B = 1, 8, 1024, 1056, with ms per CMux step;
5. ``ieache expr`` (the in-process six-role flow) for A + B - C and
   A - B * C at 32 bits, B=1;
6. ``CloudEvaluator`` at throughput shape: A+B-C at W=32, B=1024, and
   mul32 at B=32, each with the plain step and with the default choice
   — decrypt_errors must be 0.

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; any failed phase ends the script with
a non-zero exit and no such line.  Without a GPU it exits non-zero at
once.

``--four-cards`` runs only the four-card paths instead: A+B-C at W=32,
B=4096 with the operands dp-sharded over four cards, and the
(dp=2, tp=2) sharded bootstrap, each compared word for word with the
same work on one card.

    python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
KEYCACHE = os.path.join(REPO, ".keycache")
STEPS = 500


@contextlib.contextmanager
def phase(name: str):
    """Print one line per phase with its seconds; a failure propagates."""
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] ok in {time.perf_counter() - t0:.2f} s", flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def step_override(step: str):
    """Run with IEACHE_STEP=step ("" = the default choice); the step is
    read at trace time, so compiled programs are dropped around it."""
    import jax

    old = os.environ.pop("IEACHE_STEP", None)
    if step:
        os.environ["IEACHE_STEP"] = step
    jax.clear_caches()
    try:
        yield
    finally:
        os.environ.pop("IEACHE_STEP", None)
        if old is not None:
            os.environ["IEACHE_STEP"] = old
        jax.clear_caches()


# -- phases ------------------------------------------------------------------

def device_phase():
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    print(f"jax device_kind: {jax.devices()[0].device_kind}, "
          f"count: {len(jax.devices())}")


def keys_phase(params_list):
    """-> {params.name: (GateKeyPair, DeviceCloudKey)}"""
    import jax

    import ieache.boot.bootstrap as boot
    from ieache.lwe import keygen

    out = {}
    for p in params_list:
        t0 = time.perf_counter()
        pair = keygen.cached_gate_keypair(p, KEYCACHE)
        t1 = time.perf_counter()
        dck = jax.block_until_ready(boot.pack_cloud_key(pair.main.cloud))
        t2 = time.perf_counter()
        print(f"keys {p.name}: load/keygen {t1 - t0:.2f} s, "
              f"upload {t2 - t1:.2f} s")
        out[p.name] = (pair, dck)
    return out


def no_float_dots(params):
    """Every dot of the lowered CMux step and keyswitch is integer."""
    import re

    import jax
    import jax.numpy as jnp

    from ieache.ops import blind_rotate as br
    from ieache.ops.keyswitch import keyswitch

    b = 8
    acc = jnp.zeros((b, params.k + 1, params.N), jnp.int32)
    bara = jnp.zeros((b,), jnp.int32)
    bk_i = jnp.zeros((params.trgsw_rows, params.k + 1, params.N), jnp.int32)
    texts = [
        jax.jit(br.external_product_step, static_argnums=(3, 4))
        .lower(acc, bara, bk_i, params, impl).as_text()
        for impl in ("plain", "kernel")
    ]
    texts.append(jax.jit(keyswitch, static_argnums=(2,)).lower(
        jnp.zeros((b, params.kN + 1), jnp.int32),
        jnp.zeros((4, params.kN * params.ks_t, params.n + 1), jnp.int8),
        params).as_text())
    dots = [ln for t in texts for ln in t.splitlines() if "dot" in ln]
    floats = [ln for ln in dots if re.search(r"x(b?f\d+|tf32)>", ln)]
    check(not floats, f"float dot on the step: {floats[:1]}")
    return len(dots)


def oracle_phase(keys, lanes: int = 4):
    import jax.numpy as jnp

    import ieache.boot.bootstrap as boot
    from ieache.lwe import encrypt
    from ieache.native import lib as native
    from ieache.utils import prng

    for name, (pair, dck) in keys.items():
        ks, p = pair.main, pair.main.params
        stream = prng.key_from_seed_words([0x5A, p.l])
        bits = prng.uniform_bits01(prng.derive(stream, 0), lanes)
        ct = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1))
        got = np.asarray(boot.bootstrap(jnp.asarray(ct), dck))
        t0 = time.perf_counter()
        want = native.oracle_bootstrap(p, ks.cloud.bk, ks.cloud.ks, ct)
        diff = int((got != want).sum())
        ndots = no_float_dots(p)
        print(f"oracle {name}: {lanes} lanes, {diff} differing words of "
              f"{got.size} (oracle {time.perf_counter() - t0:.1f} s); "
              f"{ndots} integer dots, no float dot")
        check(diff == 0, f"{name}: {diff} words differ from the oracle")
        check((encrypt.decrypt_bits(ks, got) == bits).all(),
              f"{name}: bootstrap does not decrypt to its input")


def kernel_phase(keys, batches=(1, 8, 1024, 1056), steps: int = STEPS):
    """Kernel vs plain step over ``steps``-step scans with the real BK."""
    import jax
    import jax.numpy as jnp

    from ieache.ops import blind_rotate as br

    for name, (_pair, dck) in keys.items():
        p = dck.params
        bks = dck.bk[:steps]
        for b in batches:
            rng = np.random.default_rng(b)
            acc0 = jnp.asarray(rng.integers(
                -2**31, 2**31, (b, p.k + 1, p.N)).astype(np.int32))
            bara = jnp.asarray(rng.integers(
                0, 2 * p.N, (b, steps)).astype(np.int32))
            outs, ms = {}, {}
            for impl in ("plain", "kernel"):
                f = jax.jit(lambda a, x, y, impl=impl: br.blind_rotate(
                    a, x, y, p, impl=impl))
                outs[impl] = jax.block_until_ready(f(acc0, bara, bks))
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    jax.block_until_ready(f(acc0, bara, bks))
                    times.append(time.perf_counter() - t0)
                ms[impl] = float(np.median(times)) / steps * 1e3
            diff = int((outs["plain"] != outs["kernel"]).sum())
            print(f"step {name} B={b}: plain {ms['plain']:.4f} ms, "
                  f"kernel {ms['kernel']:.4f} ms per CMux step; "
                  f"{diff} differing words")
            check(diff == 0, f"{name} B={b}: kernel differs from plain")
            if b == 1024:
                for impl in ("plain", "kernel"):
                    c = jax.jit(br.external_product_step,
                                static_argnums=(3, 4)).lower(
                        acc0, bara[:, 0], bks[0], p, impl).compile()
                    print(f"memory {name} B=1024 {impl}: "
                          f"{c.memory_analysis()}")


def expr_phase(params_name: str = "ieache_110", width: int = 32):
    """``ieache expr`` through its CLI entry point, answers checked."""
    from ieache.cli.main import main as cli_main

    cases = [
        ("A + B - C", (2_147_000_123, -1_999_999_999, 987_654_321),
         lambda a, b, c: a + b - c),
        ("A - B * C", (-2_000_000_011, 1_999_999_973, -2_147_483_000),
         lambda a, b, c: a - b * c),
    ]
    for expr, vals, fn in cases:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_main(["expr", expr, *map(str, vals), "--params",
                      params_name, "--width", str(width),
                      "--keycache", KEYCACHE])
        dt = time.perf_counter() - t0
        got = [int(ln.split(":", 1)[1]) for ln in buf.getvalue().splitlines()
               if ln.startswith("Answer:")]
        want = fn(*vals)
        print(f"expr {expr!r} {vals}: {got} (want {want}) in {dt:.2f} s")
        check(got == [want], f"{expr}: got {got}, want {want}")


def throughput_phase(keys, params_name: str = "ieache_110_l2",
                     add_batch: int = 1024, mul_batch: int = 32,
                     width: int = 32):
    import jax

    from ieache.circuits import evaluator as ev
    from ieache.ops import blind_rotate as br
    from ieache.utils import prng

    pair, dck = keys[params_name]
    main_ks, nbit_ks = pair.main, pair.nbit
    rng = np.random.default_rng(11)
    hi = 1 << (width - 2)

    def run(label, batch, fn, want_fn, nops, op):
        vals = [[int(v) for v in rng.integers(-hi, hi, batch)]
                for _ in range(nops)]
        stream = prng.key_from_seed_words([0x7E, batch, nops])
        ops = [ev.encrypt_operand(main_ks, nbit_ks, v, width,
                                  prng.derive(stream, i))
               for i, v in enumerate(vals)]
        want = [want_fn(*xs) for xs in zip(*vals)]
        for step in ("plain", ""):            # then the default choice
            with step_override(step):
                impl = br.step_impl(dck.params)
                cloud = ev.CloudEvaluator(dck, nbit_ks)
                errors, secs = 0, []
                for _ in range(2):             # cold, then warm
                    g0 = cloud.gate_count
                    t0 = time.perf_counter()
                    ans = fn(cloud, ops)
                    jax.block_until_ready(ans.value)
                    secs.append(time.perf_counter() - t0)
                    gates = cloud.gate_count - g0
                    got = ev.decrypt_answer(main_ks, nbit_ks, ans, op)
                    errors += sum(g != w for g, w in zip(got, want))
            print(f"{label} {params_name} W={width} B={batch} step={impl}: "
                  f"decrypt_errors={errors}, cold {secs[0]:.2f} s, warm "
                  f"{secs[1]:.2f} s, {gates} bootstraps, "
                  f"{gates / secs[1]:.1f} bootstraps/s (one smoke sample, "
                  f"not a benchmark)")
            check(errors == 0, f"{label}: {errors} decrypt errors")

    run("A+B-C", add_batch,
        lambda c, o: c.compute_chain([ev.OP_ADD, ev.OP_SUB], o)[0],
        lambda a, b, c: a + b - c, 3, ev.OP_SUB)
    run("mul32", mul_batch,
        lambda c, o: c.compute(ev.OP_MUL, o[0], o[1])[0],
        lambda a, b: a * b, 2, ev.OP_MUL)


def four_card_phase(keys, add_params: str = "ieache_110_l2",
                    boot_params: str = "ieache_110_l2", batch: int = 4096,
                    width: int = 32, boot_lanes: int = 64):
    """dp-sharded A+B-C and the (dp=2, tp=2) bootstrap vs one card."""
    import jax
    import jax.numpy as jnp

    import ieache.boot.bootstrap as boot
    from ieache.circuits import evaluator as ev
    from ieache.dist import batch as dbatch
    from ieache.dist import mesh as dmesh
    from ieache.dist import shard as dshard
    from ieache.lwe import encrypt
    from ieache.utils import prng

    devs = jax.devices()
    check(len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}")

    pair, dck = keys[add_params]
    main_ks, nbit_ks = pair.main, pair.nbit
    rng = np.random.default_rng(13)
    hi = 1 << (width - 2)
    vals = [[int(v) for v in rng.integers(-hi, hi, batch)] for _ in range(3)]
    stream = prng.key_from_seed_words([0x4C, batch])
    ops = [ev.encrypt_operand(main_ks, nbit_ks, v, width,
                              prng.derive(stream, i))
           for i, v in enumerate(vals)]
    want = [a + b - c for a, b, c in zip(*vals)]

    def on_one_card(x):
        return jax.device_put(x, devs[0])

    t0 = time.perf_counter()
    one = ev.CloudEvaluator(jax.tree.map(on_one_card, dck), nbit_ks)
    ops1 = [ev.Operand(*(on_one_card(getattr(o, f)) for f in
                         ("neg_word", "bit_word", "value", "carry_word")))
            for o in ops]
    ans1, _ = one.compute_chain([ev.OP_ADD, ev.OP_SUB], ops1)
    ref = np.asarray(ans1.value)
    t_one = time.perf_counter() - t0

    mesh = dmesh.make_mesh(4, tp=1, devices=devs[:4])
    cloud = ev.CloudEvaluator(dbatch.replicate_cloud_key(dck, mesh), nbit_ks)
    ops4 = [dbatch.shard_operand(o, mesh) for o in ops]
    t0 = time.perf_counter()
    ans4, _ = cloud.compute_chain([ev.OP_ADD, ev.OP_SUB], ops4)
    jax.block_until_ready(ans4.value)
    t_four = time.perf_counter() - t0
    shards = {s.device: s.data.shape for s in ans4.value.addressable_shards}
    check(len(shards) == 4 and all(sh[0] == batch // 4
                                   for sh in shards.values()),
          f"answer not dp-sharded over 4 cards: {shards}")
    diff = int((np.asarray(ans4.value) != ref).sum())
    got = ev.decrypt_answer(main_ks, nbit_ks, ans4, ev.OP_SUB)
    errors = sum(g != w for g, w in zip(got, want))
    print(f"dp=4 A+B-C {add_params} W={width} B={batch}: {diff} words "
          f"differ from one card, decrypt_errors={errors}; shard shapes "
          f"{sorted(set(shards.values()))}; one card {t_one:.2f} s, four "
          f"cards {t_four:.2f} s (both cold)")
    check(diff == 0 and errors == 0, "dp-sharded A+B-C differs")

    pair, dck = keys[boot_params]
    p = dck.params
    bits = prng.uniform_bits01(prng.key_from_seed_words([0x4D]), boot_lanes)
    ct = jnp.asarray(encrypt.encrypt_bits(
        pair.main, bits, prng.key_from_seed_words([0x4E])))
    want_ct = np.asarray(boot.bootstrap(on_one_card(ct),
                                        jax.tree.map(on_one_card, dck)))
    m = dmesh.make_mesh(4, tp=2, devices=devs[:4])
    fn = dshard.make_sharded_bootstrap(m, p)
    bk, ksl = dshard.shard_cloud_key(dck, m)
    out = fn(dshard.shard_batch(ct, m), bk, ksl)
    diff = int((np.asarray(out) != want_ct).sum())
    print(f"(dp=2, tp=2) bootstrap {boot_params} B={boot_lanes}: {diff} "
          f"words differ from one card; mesh {dict(m.shape)}")
    check(diff == 0, "sharded bootstrap differs from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 2
    from ieache import params as P
    from ieache.utils.cache import enable_compile_cache

    enable_compile_cache()
    with phase("device"):
        device_phase()
    with phase("keys"):
        keys = keys_phase([P.IEACHE_110_FAST] if args.four_cards
                          else [P.IEACHE_110, P.IEACHE_110_FAST])
    if args.four_cards:
        with phase("four cards"):
            four_card_phase(keys)
        count = 4
    else:
        with phase("oracle parity"):
            oracle_phase(keys)
        with phase("kernel parity and timing"):
            kernel_phase(keys)
        with phase("expr, latency shape"):
            expr_phase()
        with phase("throughput shape"):
            throughput_phase(keys)
        count = len(devs)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
