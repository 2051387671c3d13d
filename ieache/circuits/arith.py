"""Homomorphic integer arithmetic circuits (batched).

Ports the *semantics* (not the code) of the reference's circuit library
in ``/root/reference/Cloud/cloud.c``:

* ``ripple_add``  — C4, `cloud.c:18-51`: 5 bootstrapped gates/bit
  (axc = x^c, bxc = y^c, sum = x^bxc, g = axc&bxc, c = c^g), emitted
  here as 3 bootstrap *rounds* per bit over a (2B, 2B, B) batch — the
  reference's 2-way OpenMP sections become batch width.
* ``zero_word`` / ``not_word`` — C5, `cloud.c:53-63`.
* ``twos_complement`` / ``ripple_sub`` — the reference's subtract path
  (NOT + add 1 + add, `cloud.c:1225-1245` semantics).
* ``schoolbook_mul`` — C7/C8/C9 generalized: W rounds of (W batched
  AND partial products + one 2W-bit accumulate add), ≈ 11.3k
  bootstraps at W=32, same count as `cloud.c:115-218`.
* ``kogge_stone_add`` — an extra of this rebuild: a parallel-prefix adder with
  O(log W) bootstrap rounds instead of O(W), for latency-bound runs
  (no reference counterpart; the reference's carry is strictly serial,
  SURVEY §5.7).

All functions take words of shape (B, W, n+1) (see circuits/words.py)
and a DeviceCloudKey.
"""

from __future__ import annotations

import jax.numpy as jnp

from ieache.boot import gates
from ieache.boot.bootstrap import DeviceCloudKey


def _flat(word):
    b, w, m = word.shape
    return word.reshape(b * w, m)


def _unflat(flat, b, w):
    return flat.reshape(b, w, flat.shape[-1])


def zero_word(batch: int, width: int, n: int) -> jnp.ndarray:
    """`zero` (C5): trivial LWE(0) fill."""
    return gates.CONSTANT(jnp.zeros((batch, width), jnp.int32), n)


def not_word(x: jnp.ndarray) -> jnp.ndarray:
    """`NOT` (C5): bitwise negation, no bootstrap."""
    return gates.NOT(x)


def ripple_add(x, y, carry_in, key: DeviceCloudKey):
    """(sum, carry_out) of two W-bit words + 1-bit carry-in.

    carry_in: (B, n+1) LWE bit.  Returns ((B, W, n+1), (B, n+1)).
    """
    b, w, _ = x.shape
    op_xor = gates.GATE_OPCODES["XOR"]
    op_and = gates.GATE_OPCODES["AND"]
    ops_mixed = jnp.concatenate(
        [jnp.full((b,), op_xor, jnp.int32), jnp.full((b,), op_and, jnp.int32)]
    )

    carry = carry_in
    sums = []
    for i in range(w):
        xi = x[:, i]
        yi = y[:, i]
        # round 1: axc = x^c, bxc = y^c  (one 2B-batch bootstrap)
        both = gates.XOR(
            jnp.concatenate([xi, yi], 0),
            jnp.concatenate([carry, carry], 0),
            key,
        )
        axc, bxc = both[:b], both[b:]
        # round 2: sum = x^bxc, g = axc&bxc  (one mixed 2B-batch bootstrap)
        mixed = gates.apply_gate_batch(
            ops_mixed,
            jnp.concatenate([xi, axc], 0),
            jnp.concatenate([bxc, bxc], 0),
            key,
        )
        sum_i, g = mixed[:b], mixed[b:]
        # round 3: c = c^g
        carry = gates.XOR(carry, g, key)
        sums.append(sum_i)
    return jnp.stack(sums, axis=1), carry


def twos_complement(x, key: DeviceCloudKey):
    """-x over W bits: NOT(x) + 1 (reference subtract-path semantics)."""
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
    s, _ = ripple_add(not_word(x), one, zero_c, key)
    return s


def ripple_sub(x, y, key: DeviceCloudKey):
    """x - y over W bits (two's complement): x + NOT(y) + carry_in=1."""
    b = x.shape[0]
    n = key.params.n
    one_c = gates.CONSTANT(jnp.ones((b,), jnp.int32), n)
    return ripple_add(x, not_word(y), one_c, key)


def shift_word_left(x, amount: int, total_width: int, n: int):
    """Zero-extend x into `total_width` bits shifted up by `amount`
    (the reference's shift-copy rounds, `cloud.c:164-192`; free — no
    bootstraps, trivial zeros elsewhere)."""
    b, w, m = x.shape
    lo = gates.CONSTANT(jnp.zeros((b, amount), jnp.int32), n)
    keep = min(w, total_width - amount)
    hi_len = total_width - amount - keep
    parts = [lo, x[:, :keep]]
    if hi_len > 0:
        parts.append(gates.CONSTANT(jnp.zeros((b, hi_len), jnp.int32), n))
    return jnp.concatenate(parts, axis=1)


def schoolbook_mul(x, y, key: DeviceCloudKey, out_width: int | None = None):
    """W x W -> out_width (default 2W) bit product, unsigned.

    Round i: batched AND partial products x_k & y_i (one B*W-batch
    bootstrap), shift-copy, one out_width-bit accumulate add — the
    mul32/64/128 pattern of `cloud.c:115-647`.
    """
    b, w, _ = x.shape
    n = key.params.n
    ow = out_width or 2 * w
    acc = zero_word(b, ow, n)
    zero_c = gates.CONSTANT(jnp.zeros((b,), jnp.int32), n)
    xf = _flat(x)  # (B*W, n+1)
    for i in range(w):
        yi_rep = jnp.repeat(y[:, i][:, None, :], w, axis=1)
        partial = gates.AND(xf, _flat(yi_rep), key)
        partial = _unflat(partial, b, w)              # (B, W)
        shifted = shift_word_left(partial, i, ow, n)  # (B, OW)
        acc, _ = ripple_add(acc, shifted, zero_c, key)
    return acc


# ---------------------------------------------------------------------------
# Latency option: parallel-prefix (Kogge-Stone) adder
# ---------------------------------------------------------------------------

def kogge_stone_add(x, y, key: DeviceCloudKey, carry_in=None):
    """W-bit add in O(log W) bootstrap rounds.

    p = x^y, g = x&y; then log2(W) combine levels
    (g' = g | (p & g_shift), p' = p & p_shift); sum = p ^ carries.
    ~2 + 2*ceil(log2 W) rounds vs 3W for ripple — the parallel-scan
    answer to the reference's serial carry chain (SURVEY §5.7).
    """
    b, w, _ = x.shape
    n = key.params.n
    op_xor = gates.GATE_OPCODES["XOR"]
    op_and = gates.GATE_OPCODES["AND"]

    # round 1: p = x^y and g = x&y in one 2BW-batch bootstrap
    ops0 = jnp.concatenate(
        [jnp.full((b * w,), op_xor, jnp.int32),
         jnp.full((b * w,), op_and, jnp.int32)]
    )
    xy = jnp.concatenate([_flat(x), _flat(x)], 0)
    yy = jnp.concatenate([_flat(y), _flat(y)], 0)
    pg = gates.apply_gate_batch(ops0, xy, yy, key)
    p0 = _unflat(pg[: b * w], b, w)            # propagate (kept for sum)
    g = _unflat(pg[b * w:], b, w)              # generate

    # carry-in rides as a virtual bit position -1: p=0, g=cin
    if carry_in is None:
        cin = gates.CONSTANT(jnp.zeros((b,), jnp.int32), n)
    else:
        cin = carry_in
    g = jnp.concatenate([cin[:, None, :], g], axis=1)          # (B, W+1)
    p = jnp.concatenate(
        [gates.CONSTANT(jnp.zeros((b, 1), jnp.int32), n), p0], axis=1
    )

    # combine levels: g' = g | (p & g_shift), p' = p & p_shift.
    # The two ANDs (t = p & g_shift, p' = p & p_shift) are mutually
    # independent, so they run as ONE bootstrap wave; only the OR
    # depends on t — 2 serial waves per level instead of 3 (r5: at
    # B=8 the expression latency is wave-count-bound, and this cut is
    # pure scheduling — same gates, bit-identical results).
    op_and = gates.GATE_OPCODES["AND"]
    we = w + 1
    dist = 1
    while dist < we:
        span = we - dist
        p_shift = _flat(p[:, dist:, :])
        ops_l = jnp.full((2 * b * span,), op_and, jnp.int32)
        both = gates.apply_gate_batch(
            ops_l,
            jnp.concatenate([p_shift, p_shift], 0),
            jnp.concatenate(
                [_flat(g[:, :span, :]), _flat(p[:, :span, :])], 0
            ),
            key,
        )
        t, p_hi = both[: b * span], both[b * span:]
        g_hi = gates.OR(_flat(g[:, dist:, :]), t, key)
        g = jnp.concatenate([g[:, :dist, :], _unflat(g_hi, b, span)], 1)
        p = jnp.concatenate([p[:, :dist, :], _unflat(p_hi, b, span)], 1)
        dist *= 2

    # carry into real bit i = inclusive prefix generate g[i] (covers
    # virtual..i-1); sum_i = p0_i ^ carry_i; carry_out = g[W]
    carries = g[:, :w, :]
    s = gates.XOR(_flat(p0), _flat(carries), key)
    return _unflat(s, b, w), g[:, w]
