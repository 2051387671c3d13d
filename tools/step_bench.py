#!/usr/bin/env python
"""Per-step cost of the CMux step: the plain XLA step, the Hopper
external-product kernel and the CRT-NTT step.

For every parameter set and batch it runs a ``--steps``-step scan of
each implementation on random keys and accumulators, checks that every
implementation ends on the same accumulator bit for bit as the plain
step, and prints one JSON line per (params, batch, impl) with the ms
per step (host clock around ``block_until_ready``).  ``--tiles``
adds kernel block shapes to compare against the default choice
(``bm:bn:bk:split:warps:stages``).  ``--hlo DIR`` writes the optimized
HLO of the plain step and of the keyswitch there.

Example (on a GPU):
    python tools/step_bench.py --params ieache_110,ieache_110_l2 \\
        --batch 1,8,1024 --steps 500
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _scan(impl, p, tiles=None):
    import jax

    from ieache.ops import blind_rotate as br
    from ieache.ops.pallas_kernels import external_product

    if impl == "ntt":
        return jax.jit(lambda acc, bks, bara: br._blind_rotate_ntt(
            acc, bara.T, bks, p))

    def step(acc, xs):
        bk_i, bara_i = xs
        if tiles is None:
            return br.external_product_step(acc, bara_i, bk_i, p, impl), None
        d = br._step_digits(acc, bara_i, p)
        return acc + external_product(d, bk_i, p, tiles=tiles), None

    return jax.jit(
        lambda acc, bks, bara: jax.lax.scan(step, acc, (bks, bara))[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", default="ieache_110")
    ap.add_argument("--batch", default="1,8,1024")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--impls", default="plain,kernel")
    ap.add_argument("--tiles", default="",
                    help="extra kernel tiles, bm:bn:bk:split:warps:stages,…")
    ap.add_argument("--hlo", default="")
    args = ap.parse_args(argv)

    from ieache.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from ieache.cli.main import _params
    from ieache.ops import blind_rotate as br
    from ieache.ops.keyswitch import keyswitch
    from ieache.ops.pallas_kernels import Tiles

    extra = [Tiles(*map(int, t.split(":")))
             for t in args.tiles.split(",") if t]
    dev = jax.devices()[0]
    for pname in args.params.split(","):
        p = _params(pname)
        rows, kp1, n = p.trgsw_rows, p.k + 1, p.N
        rng = np.random.RandomState(7)
        bks = jnp.asarray(rng.randint(
            -2**31, 2**31, (args.steps, rows, kp1, n)).astype(np.int32))
        if args.hlo:
            os.makedirs(args.hlo, exist_ok=True)
            acc = jnp.zeros((1024, kp1, n), jnp.int32)
            bara = jnp.zeros((1024,), jnp.int32)
            txt = jax.jit(br.external_product_step, static_argnums=(3,)) \
                .lower(acc, bara, bks[0], p).compile().as_text()
            with open(os.path.join(args.hlo, f"step_{pname}.txt"), "w") as f:
                f.write(txt)
            ks = jnp.zeros((4, p.kN * p.ks_t, p.n + 1), jnp.int8)
            lwe = jnp.zeros((1024, p.kN + 1), jnp.int32)
            txt = jax.jit(keyswitch, static_argnums=(2,)) \
                .lower(lwe, ks, p).compile().as_text()
            with open(os.path.join(args.hlo, f"keyswitch_{pname}.txt"),
                      "w") as f:
                f.write(txt)
        for b in map(int, args.batch.split(",")):
            acc0 = jnp.asarray(
                rng.randint(-2**31, 2**31, (b, kp1, n)).astype(np.int32))
            bara = jnp.asarray(
                rng.randint(0, 2 * n, (args.steps, b)).astype(np.int32))
            runs = [(i, None) for i in args.impls.split(",")]
            runs += [("kernel", t) for t in extra]
            want = None
            for impl, tiles in runs:
                f = _scan(impl, p, tiles)
                t0 = time.perf_counter()
                out = jax.block_until_ready(f(acc0, bks, bara))
                compile_s = time.perf_counter() - t0
                if want is None:
                    want = out
                times = []
                for _ in range(args.iters):
                    t0 = time.perf_counter()
                    jax.block_until_ready(f(acc0, bks, bara))
                    times.append(time.perf_counter() - t0)
                ms = float(np.median(times)) / args.steps * 1e3
                print(json.dumps({
                    "params": pname, "b": b, "impl": impl,
                    "tiles": None if tiles is None else tiles.__dict__,
                    "ms_per_step": ms,
                    "ms_per_step_all": [t / args.steps * 1e3 for t in times],
                    "compile_s": compile_s,
                    "equal_to_first": bool(jnp.array_equal(out, want)),
                    "device": dev.device_kind,
                }), flush=True)


if __name__ == "__main__":
    main()
