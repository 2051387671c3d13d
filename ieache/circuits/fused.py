"""Fused circuit kernels: one jit dispatch per arithmetic op.

The naive circuit layer (circuits/arith.py) issues 3 jitted bootstrap
calls per adder bit, each with its own dispatch and host round trip.
These variants evaluate the *entire* W-bit op inside a single jitted
program — a `lax.scan` over bit positions whose
body contains the (batched) gate bootstraps — so the whole add/sub/mul
is one dispatch and the bootstrap scan body still compiles once.

Two adder circuits are available (IEACHE_ADDER, default ``maj2``):
``ref5`` replicates the reference's 5-gate/bit full adder
(`Cloud/cloud.c:18-51`, 3 bootstrap rounds/bit); ``maj2`` computes the
same truth table in 2 bootstraps/bit (majority-vote carry + parity
fix-up) — 2.5x fewer bootstraps, margin-validated on hardware.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ieache.boot import gates
from ieache.boot.bootstrap import MU, DeviceCloudKey
from ieache.ops.blind_rotate import blind_rotate
from ieache.ops.keyswitch import keyswitch
import ieache.boot.bootstrap as boot


def _bootstrap_raw(pre: jnp.ndarray, key: DeviceCloudKey) -> jnp.ndarray:
    """Unjitted bootstrap body (for embedding in larger programs)."""
    p = key.params
    n = p.n
    a, b = pre[:, :n], pre[:, n]
    bara = boot.mod_switch_2n(a, p)
    barb = boot.mod_switch_2n(b, p)
    acc0 = jnp.zeros((pre.shape[0], p.k + 1, p.N), jnp.int32)
    acc0 = acc0.at[:, p.k, :].set(
        boot._rotated_test_vector(barb, MU, p)
    )
    acc = blind_rotate(acc0, bara, key.bk, p)
    ext = boot.sample_extract(acc, p)
    return keyswitch(ext, key.ks_limbs, p)


def _adder_bit_step(key: DeviceCloudKey, carry, xs):
    """One full-adder bit: 5 gates in 3 bootstrap rounds (2B, 2B, B)."""
    xi, yi = xs
    b = xi.shape[0]
    n = key.params.n

    # round 1: axc = x^c, bxc = y^c
    pre = 2 * jnp.concatenate([xi, yi], 0) + 2 * jnp.concatenate(
        [carry, carry], 0
    )
    pre = pre.at[:, n].add(jnp.int32(2 * MU))
    both = _bootstrap_raw(pre, key)
    axc, bxc = both[:b], both[b:]

    # round 2: sum = x^bxc (XOR), g = axc&bxc (AND)
    pre2_x = jnp.concatenate([2 * xi, axc], 0)
    pre2_y = jnp.concatenate([2 * bxc, bxc], 0)
    pre2 = pre2_x + pre2_y
    beta = jnp.concatenate(
        [jnp.full((b,), 2 * MU, jnp.int32),
         jnp.full((b,), -MU, jnp.int32)]
    )
    pre2 = pre2.at[:, n].add(beta)
    mixed = _bootstrap_raw(pre2, key)
    sum_i, g = mixed[:b], mixed[b:]

    # round 3: c = c ^ g
    pre3 = 2 * carry + 2 * g
    pre3 = pre3.at[:, n].add(jnp.int32(2 * MU))
    carry = _bootstrap_raw(pre3, key)
    return carry, sum_i


def _adder_bit_step_maj2(key: DeviceCloudKey, carry, xs):
    """One full-adder bit in TWO bootstraps (vs the reference's 5-gate
    3-round circuit, `cloud.c:18-51` — same truth table, 2.5x fewer
    bootstraps):

        carry' = sign(x + y + c)                 (majority vote)
        sum    = sign(x + y + c - 2*carry')      (parity fix-up)

    Phases: x+y+c ∈ {±3μ, ±μ} so its sign IS the majority; subtracting
    2·(±μ) folds the four cases onto ±μ with the right parity.  Noise
    of the second combo is sqrt(3σ_in² + 4σ_boot²) ≈ 2.6σ_boot —
    inside the same margin regime as the XOR combo's 2√2 factor
    (tools/margin_probe.py measures >7σ).
    """
    xi, yi = xs
    pre = xi + yi + carry                  # {±3μ, ±μ}: sign = majority
    carry_new = _bootstrap_raw(pre, key)
    sum_i = _bootstrap_raw(pre - 2 * carry_new, key)
    return carry_new, sum_i


@functools.partial(jax.jit, static_argnames=("mode",))
def _ripple_add_fused(x, y, carry_in, key: DeviceCloudKey,
                      mode: str = "maj2"):
    xs = (jnp.moveaxis(x, 1, 0), jnp.moveaxis(y, 1, 0))  # (W, B, n+1)
    step = _adder_bit_step_maj2 if mode == "maj2" else _adder_bit_step
    carry, sums = jax.lax.scan(
        functools.partial(step, key), carry_in, xs
    )
    return jnp.moveaxis(sums, 0, 1), carry


#: bootstraps per adder bit, by mode (evaluator gate accounting)
ADDER_BOOTSTRAPS_PER_BIT = {"maj2": 2, "ref5": 5}


def adder_mode() -> str:
    """Fused adder circuit: IEACHE_ADDER=ref5 selects the reference's
    5-gate full adder; default maj2 (2 bootstraps/bit)."""
    import os

    mode = os.environ.get("IEACHE_ADDER", "maj2")
    if mode not in ADDER_BOOTSTRAPS_PER_BIT:
        raise ValueError(f"IEACHE_ADDER must be maj2|ref5, got {mode!r}")
    return mode


def ripple_add(x, y, carry_in, key: DeviceCloudKey, mode: str | None = None):
    """Drop-in fused replacement for arith.ripple_add."""
    return _ripple_add_fused(x, y, carry_in, key, mode or adder_mode())


@jax.jit
def kogge_stone_add(x, y, key: DeviceCloudKey, carry_in):
    """arith.kogge_stone_add as ONE jit dispatch — the unfused variant
    issues ~2·log2(W) separate jitted gate calls."""
    from ieache.circuits import arith

    return arith.kogge_stone_add(x, y, key, carry_in=carry_in)


def csa3_add(a, b, c, u, v, key: DeviceCloudKey):
    """Fused three-term addition ``(a + b + c + k0 + 2·k1) mod 2^W``
    in 2 + depth(KS) bootstrap waves — the r5 latency path for the
    reference's pure-add Fig.7 expressions (A±B±C as ONE carry-free
    3:2 compression + ONE parallel-prefix add, ~14 serial waves at
    W=16 vs 24 for two chained adds).

    The compression is bit-parallel (no carry chain): per bit,
    ``a+b+c = s + 2·maj`` with s the 3-input parity (two XOR waves,
    the first batched with the majority wave) and maj the existing
    maj2 trick (``sign(a+b+c)`` — same gate family and noise as the
    shipped maj2 adder, no margin change).  The cleartext carry
    constant K in {0..2} from the per-lane sign dataflow rides in as
    TWO unit carries u + v = K ((K>=1), (K>=2)): u in the final
    adder's carry-in, v in the freed (weight-1) bit-0 slot of the
    shifted majority word — both slots add 1, so the sum gains
    exactly K.

    a, b, c: (B, W, n+1) bit words; u, v: (B,) cleartext 0/1.
    """
    bsz, w, m = a.shape
    n = key.params.n

    # wave 1: xab = XOR(a, b) batched with maj = MAJ(a, b, c)
    pre_xor = 2 * a + 2 * b
    pre_xor = pre_xor.at[:, :, n].add(jnp.int32(2 * MU))
    pre_maj = a + b + c
    both = _bootstrap_raw(
        jnp.concatenate([pre_xor, pre_maj], 0).reshape(2 * bsz * w, m),
        key,
    ).reshape(2 * bsz, w, m)
    xab, maj = both[:bsz], both[bsz:]

    # wave 2: s = XOR(xab, c)
    pre_s = 2 * xab + 2 * c
    pre_s = pre_s.at[:, :, n].add(jnp.int32(2 * MU))
    s = _bootstrap_raw(pre_s.reshape(bsz * w, m), key).reshape(
        bsz, w, m
    )

    # maj << 1 (mod 2^W truncation), bit 0 = trivial enc of v
    vw = gates.CONSTANT(v.astype(jnp.int32)[:, None], n)
    mword = jnp.concatenate([vw, maj[:, : w - 1, :]], axis=1)

    cin = gates.CONSTANT(u.astype(jnp.int32), n)
    out, carry = kogge_stone_add(s, mword, key, carry_in=cin)
    return out, carry


def _compress3_words(triples, key: DeviceCloudKey):
    """One Wallace layer: every (a, b, c) word triple compressed 3:2
    in TWO batched bootstrap waves (all triples share the waves).

    triples: list of (a, b, c), each (B, L, n+1).  Returns
    [sum_i, maj_i] flattened — exact per bit column: a+b+c = s +
    2*maj; the caller places maj one bit position up (support
    tracking owns the shift and the mod-2^L truncation).
    """
    n = key.params.n
    bsz, L, m = triples[0][0].shape
    g = len(triples)
    a = jnp.concatenate([t[0] for t in triples], 0)  # (g*B, L, m)
    b = jnp.concatenate([t[1] for t in triples], 0)
    c = jnp.concatenate([t[2] for t in triples], 0)

    pre_xor = 2 * a + 2 * b
    pre_xor = pre_xor.at[:, :, n].add(jnp.int32(2 * MU))
    pre_maj = a + b + c
    both = _bootstrap_raw(
        jnp.concatenate([pre_xor, pre_maj], 0).reshape(2 * g * bsz * L, m),
        key,
    ).reshape(2 * g * bsz, L, m)
    xab, maj = both[: g * bsz], both[g * bsz:]

    pre_s = 2 * xab + 2 * c
    pre_s = pre_s.at[:, :, n].add(jnp.int32(2 * MU))
    s = _bootstrap_raw(pre_s.reshape(g * bsz * L, m), key).reshape(
        g * bsz, L, m
    )

    out = []
    for i in range(g):
        out.append(s[i * bsz:(i + 1) * bsz])
        out.append(maj[i * bsz:(i + 1) * bsz])  # weight: column + 1
    return out


def _mul_wallace(partials, key: DeviceCloudKey):
    """Wallace-tree product from precomputed partials: log-depth 3:2
    compression (2 batched waves per layer) + ONE parallel-prefix add
    — the latency multiplier (r5).  partials (Wy, B, Wx, n+1), row i
    weighted 2^i; returns (B, Wx+Wy, n+1), exact mod 2^(Wx+Wy).

    vs the windowed CSA's 2*Wy serial compress waves, the tree runs in
    2*ceil(log_{3/2}) layers (~16 waves at W=32) at ~2x the compress
    bootstraps — the latency/throughput trade the amode=kogge config
    exists for.
    """
    wy, bsz, wx, m = partials.shape
    n = key.params.n
    L = wx + wy

    # Dadda-style support tracking: every word carries its absolute
    # bit offset `lo`; a layer compresses each triple only over the
    # triple's union span (padded to the layer max for wave batching)
    # instead of the full 2W — statically-known-zero columns cost no
    # bootstraps (~40% fewer compress gates at W=32)
    def zpad(word, left, right):
        cols = []
        if left:
            cols.append(_like_vma(gates.CONSTANT(
                jnp.zeros((bsz, left), jnp.int32), n), word))
        cols.append(word)
        if right:
            cols.append(_like_vma(gates.CONSTANT(
                jnp.zeros((bsz, right), jnp.int32), n), word))
        return jnp.concatenate(cols, axis=1)

    words = [(partials[i], i) for i in range(wy)]  # (tensor, lo)
    while len(words) > 2:
        words.sort(key=lambda t: t[1])
        g = len(words) // 3
        triples_meta = []
        span_max = 0
        for j in range(g):
            grp = words[3 * j:3 * j + 3]
            lo_g = min(t[1] for t in grp)
            hi_g = max(t[1] + t[0].shape[1] for t in grp)
            triples_meta.append((grp, lo_g, hi_g))
            span_max = max(span_max, hi_g - lo_g)
        triples = []
        for grp, lo_g, hi_g in triples_meta:
            padded = tuple(
                zpad(t[0], t[1] - lo_g,
                     span_max - (t[1] - lo_g) - t[0].shape[1])
                for t in grp
            )
            triples.append(padded)
        outs = _compress3_words(triples, key)
        nxt = []
        for j, (grp, lo_g, hi_g) in enumerate(triples_meta):
            s_w, c_w = outs[2 * j], outs[2 * j + 1]
            # columns past L drop (mod 2^L) — padded-to-layer-max
            # words of high-offset groups can stick out
            keep_s = min(span_max, L - lo_g)
            nxt.append((s_w[:, :keep_s, :], lo_g))
            # carry covers [lo_g+1, lo_g+1+span); truncate mod 2^L
            keep = min(span_max, L - (lo_g + 1))
            if keep > 0:
                nxt.append((c_w[:, :keep, :], lo_g + 1))
        words = nxt + words[3 * g:]
    full = [zpad(t, lo, L - lo - t.shape[1]) for t, lo in words]
    if len(full) == 1:
        return full[0]
    zero_bit = _like_vma(
        gates.CONSTANT(jnp.zeros((bsz,), jnp.int32), n), full[0]
    )
    out, _ = kogge_stone_add(full[0], full[1], key, carry_in=zero_bit)
    return out


def _kogge_count_fz(w: int) -> int:
    count, we, dist = 3 * w, w + 1, 1
    while dist < we:
        count += 3 * (we - dist)
        dist *= 2
    return count


def _wallace_bootstraps(wx: int, wy: int) -> int:
    """Exact per-lane bootstrap count of the Wallace latency multiply
    (partials + support-trimmed 3:2 layers + one prefix add) — mirrors
    :func:`_mul_wallace`'s interval bookkeeping exactly."""
    L = wx + wy
    count = wx * wy
    words = [(i, i + wx) for i in range(wy)]
    while len(words) > 2:
        words.sort()
        g = len(words) // 3
        metas = []
        span_max = 0
        for j in range(g):
            grp = words[3 * j:3 * j + 3]
            lo_g = min(lo for lo, _ in grp)
            hi_g = max(hi for _, hi in grp)
            metas.append(lo_g)
            span_max = max(span_max, hi_g - lo_g)
        nxt = []
        for lo_g in metas:
            count += 3 * span_max      # xor + maj + xor per column
            nxt.append((lo_g, min(lo_g + span_max, L)))
            keep = min(span_max, L - (lo_g + 1))
            if keep > 0:
                nxt.append((lo_g + 1, lo_g + 1 + keep))
        words = nxt + words[3 * g:]
    if len(words) == 2:
        count += _kogge_count_fz(L)
    return count


@jax.jit
def twos_complement(x, key: DeviceCloudKey):
    b, w, _ = x.shape
    n = key.params.n
    one = gates.CONSTANT(
        jnp.concatenate(
            [jnp.ones((b, 1), jnp.int32), jnp.zeros((b, w - 1), jnp.int32)],
            axis=1,
        ),
        n,
    )
    zero_c = gates.CONSTANT(jnp.zeros((b,), jnp.int32), n)
    s, _ = _ripple_add_fused(-x, one, zero_c, key, adder_mode())
    return s


@jax.jit
def add_then_sub(a, b_, c, key: DeviceCloudKey):
    """(a + b) - c in ONE dispatch (the reference's A+B-C flow)."""
    batch = a.shape[0]
    n = key.params.n
    zero_c = gates.CONSTANT(jnp.zeros((batch,), jnp.int32), n)
    one_c = gates.CONSTANT(jnp.ones((batch,), jnp.int32), n)
    mode = adder_mode()
    ab, _ = _ripple_add_fused(a, b_, zero_c, key, mode)
    s, _ = _ripple_add_fused(ab, -c, one_c, key, mode)
    return s


def _like_vma(const: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """Stamp `const` with `ref`'s varying-manual-axes (shard_map VMA).

    Inside shard_map, a freshly built constant is device-invariant
    while values derived from sharded inputs are axis-varying; a
    lax.scan whose carry is initialized from the constant but updated
    from sharded data then fails jax 0.9's VMA type check.  Adding a
    zero scalar slice of `ref` (exact int32, folded by XLA) makes the
    constant inherit `ref`'s vma; outside shard_map it is a no-op.
    """
    z = ref
    while z.ndim > 0:
        z = z[0]
    return const + z * 0


def _mul_shift_matrices(w: int, ow: int):
    """Shift one-hots: for round i, matrix (2W, W) with [i+k, k] = 1."""
    eye = jnp.eye(w, dtype=jnp.int32)
    return jnp.stack(
        [
            jnp.concatenate(
                [jnp.zeros((i, w), jnp.int32), eye,
                 jnp.zeros((ow - w - i, w), jnp.int32)], axis=0
            )
            for i in range(w)
        ]
    )  # (W, 2W, W)


def _and_partial(xf, yi, w, key: DeviceCloudKey):
    """All W partial products x_k AND y_i as ONE bootstrap wave."""
    n = key.params.n
    pre = xf + jnp.repeat(yi, w, axis=0)
    pre = pre.at[:, n].add(jnp.int32(-MU))
    return _bootstrap_raw(pre, key)


def _place_partial(partial, shift_onehot, n):
    """Scatter W partial-product bits into a 2W word at the round's
    offset via a selection matmul; uncovered rows become trivial
    encryptions of 0 (body = -MU), the reference's CONSTANT(0) fill."""
    shifted = jnp.einsum(
        "jw,bwm->bjm", shift_onehot, partial,
        preferred_element_type=jnp.int32,
    )
    covered = jnp.sum(shift_onehot, axis=1)               # (2W,)
    return shifted.at[:, :, n].add(
        (1 - covered)[None, :] * jnp.int32(-MU)
    )


@functools.partial(jax.jit, static_argnames=("latency",))
def schoolbook_mul_csa(x, y, key: DeviceCloudKey,
                       latency: bool = False):
    """W x W -> 2W bit product via a *windowed* carry-save accumulator,
    one dispatch.

    The reference's mul32 (`cloud.c:115-218`) ripple-adds each shifted
    partial product into the accumulator — W rounds x a 2W-bit serial
    carry chain (~4W² serial bootstrap waves of only B lanes each).
    Here the accumulator is a redundant (sum, carry) pair and each
    round folds its partial in with ONE 3:2 compressor (no carry
    chain):

        maj  = sign(s + c + p)             (majority = carry bit)
        sum' = sign(s + c + p - 2·maj)     (parity fix-up)

    — the maj2 full-adder trick (`_adder_bit_step_maj2`) applied
    bit-parallel.  Round i's partial covers absolute bits [i, i+W)
    only, so the redundant state is a **W+1-bit sliding window**, not
    the full 2W bits (the r3 shape): the window's bottom bit receives
    its last contribution in round i and pops out FINAL each round
    (scan output), the window slides up one bit, and partials always
    land at window offset 0 — which also deletes the per-round
    shift-matrix einsum.  One W-bit carry-propagate add at the end
    resolves the remaining window.

    Totals: W² AND + 2·W·(W+1) compress + pb·W final-add bootstraps
    (vs W² + 4W² + 2·pb·2W for the r3 full-width variant — ~40% fewer)
    and the live scan state drops from 2·(B, 2W, n+1) to
    2·(B, W+1, n+1) (~2x), which is what bounds the A*B*C chain's
    second multiply.
    """
    b, w, m = x.shape
    wy = y.shape[1]
    n = key.params.n

    zero_col = _like_vma(
        gates.CONSTANT(jnp.zeros((b, 1), jnp.int32), n), x
    )
    win0 = _like_vma(
        gates.CONSTANT(jnp.zeros((b, w + 1), jnp.int32), n), x
    )
    xf = x.reshape(b * w, m)
    ys = jnp.moveaxis(y, 1, 0)                 # (Wy, B, n+1)

    # latency mode (r5, amode=kogge): every partial product is
    # independent of every round, so ALL Wy*Wx ANDs run as ONE
    # upfront bootstrap wave (3 -> 2 serial waves per round); capped
    # at 64k lanes so a misconfigured huge batch falls back to the
    # per-round wave (same bootstrap COUNT either way)
    pre_all = latency and (b * w * wy) <= 65536
    if pre_all:
        pre = (xf[None, :, :]
               + jnp.repeat(ys, w, axis=1))    # (Wy, B*Wx, m)
        pre = pre.at[:, :, n].add(jnp.int32(-MU))
        partials = _bootstrap_raw(
            pre.reshape(wy * b * w, m), key
        ).reshape(wy, b, w, m)
        if b * (w + 1) <= 64:
            # truly wave-bound regime (e.g. B=1): the Wallace tree's
            # log depth wins despite ~1.7x the compress bootstraps.
            # At b*(W+1) > ~64 lanes the windowed scan's waves already
            # keep the chip near its throughput peak and extra gates
            # cost linearly (measured r5: B=8 W=16 A-B*C 1.77 s
            # windowed vs 2.55 s Wallace; B=1 W=32 2.11 vs 2.05)
            return _mul_wallace(partials, key)

    def round_step(carry, xs_i):
        sw, cw = carry                         # (B, W+1, m) each
        if pre_all:
            partial = xs_i
        else:
            partial = _and_partial(xf, xs_i, w, key).reshape(b, w, m)
        p = jnp.concatenate([partial, zero_col], axis=1)
        tot = (sw + cw + p).reshape(b * (w + 1), m)  # {±3μ, ±μ}
        maj = _bootstrap_raw(tot, key)
        sum_ = _bootstrap_raw(tot - 2 * maj, key).reshape(b, w + 1, m)
        out_bit = sum_[:, 0, :]                # absolute bit i: FINAL
        # slide the window: sum' moves down one slot (bit i+1 becomes
        # the new bottom), maj lands one bit up == the same new slots
        sw_new = jnp.concatenate([sum_[:, 1:, :], zero_col], axis=1)
        cw_new = maj.reshape(b, w + 1, m)
        return (sw_new, cw_new), out_bit

    (sw, cw), low_bits = jax.lax.scan(
        round_step, (win0, win0), partials if pre_all else ys
    )
    low = jnp.moveaxis(low_bits, 0, 1)         # (B, Wy, m): bits 0..
    zero_bit = _like_vma(
        gates.CONSTANT(jnp.zeros((b,), jnp.int32), n), x
    )
    # resolve the remaining window = absolute bits Wy..Wy+Wx (top
    # drops mod 2^(Wx+Wy)); latency mode uses the parallel-prefix
    # adder (O(log W) waves vs the W-serial ripple)
    if latency:
        hi, _ = kogge_stone_add(sw[:, :w, :], cw[:, :w, :], key,
                                carry_in=zero_bit)
    else:
        hi, _ = _ripple_add_fused(sw[:, :w, :], cw[:, :w, :],
                                  zero_bit, key, adder_mode())
    return jnp.concatenate([low, hi], axis=1)


def _csa_bootstraps_xy(wx: int, wy: int, pb: int) -> int:
    """Windowed-CSA bootstraps for an ASYMMETRIC Wx x Wy -> Wx+Wy
    multiply: Wy rounds x (Wx ANDs + 2*(Wx+1) compress) + a Wx-bit
    final carry-propagate.  The kernel itself is width-asymmetric
    (rounds scan y's bits; the window is sized by x), so a 32x16
    product costs ~half a 32x32 one — the evaluator passes each
    operand's TRUE nbit width (cleartext metadata, exactly the
    reference's own width dispatch, `cloud.c:832-864`)."""
    return wx * wy + 2 * wy * (wx + 1) + pb * wx


#: bootstraps per multiply lane, by mode (evaluator accounting);
#: pb = adder bootstraps/bit.  Symmetric W x W form; csa's asymmetric
#: form is :func:`_csa_bootstraps_xy`.
MUL_BOOTSTRAPS = {
    "csa": lambda w, pb: _csa_bootstraps_xy(w, w, pb),
    "shift": lambda w, pb: (1 + 2 * pb) * w * w,
}


def mul_mode() -> str:
    """Fused multiplier circuit: IEACHE_MUL=shift selects the
    reference-style shift-and-add accumulator; default csa
    (carry-save, ~W x lower serial depth)."""
    import os

    mode = os.environ.get("IEACHE_MUL", "csa")
    if mode not in MUL_BOOTSTRAPS:
        raise ValueError(f"IEACHE_MUL must be csa|shift, got {mode!r}")
    return mode


@jax.jit
def schoolbook_mul_fused(x, y, key: DeviceCloudKey):
    """W x W -> 2W bit product, one dispatch.

    Round i: AND partials (one B*W bootstrap) + 2W-bit accumulate add
    (the mul32 pattern, `cloud.c:115-218`), all inside a scan over i.
    """
    b, w, m = x.shape
    n = key.params.n
    ow = 2 * w

    zero_bit = _like_vma(
        gates.CONSTANT(jnp.zeros((b,), jnp.int32), n), x
    )
    acc0 = _like_vma(
        gates.CONSTANT(jnp.zeros((b, ow), jnp.int32), n), x
    )
    xf = x.reshape(b * w, m)
    ys = jnp.moveaxis(y, 1, 0)  # (W, B, n+1)
    shift_mats = _mul_shift_matrices(w, ow)

    def round_step(acc, yi_and_shift):
        yi, shift_onehot = yi_and_shift
        partial = _and_partial(xf, yi, w, key).reshape(b, w, m)
        shifted = _place_partial(partial, shift_onehot, n)
        acc, _ = _ripple_add_fused(acc, shifted, zero_bit, key,
                                   adder_mode())
        return acc, None

    acc, _ = jax.lax.scan(round_step, acc0, (ys, shift_mats))
    return acc
