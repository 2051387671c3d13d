"""Reference-width arithmetic exercised end-to-end (tiny params, CPU).

Round-1 VERDICT: mul32/64/128 (`Cloud/cloud.c:115-218`, `:220-385`,
`:387-647`) and 256-bit addition were parameterized but never run.
These tests execute every reference width through the full
CloudEvaluator (metadata, sign dispatch, width doubling, decrypt) at
TEST_TINY.  The analytical bootstrap counts from BASELINE.md §Derived
are asserted as the cross-check; hardware runs of the same widths are
recorded by tools/width_bench.py.
"""

import pytest

import ieache.boot.bootstrap as B
from ieache import params as P
from ieache.circuits import evaluator as ev
from ieache.circuits import fused
from ieache.lwe import keygen
from ieache.utils import prng

_CACHE = {}


def _setup():
    if "pair" not in _CACHE:
        pair = keygen.generate_gate_keypair(P.TEST_TINY)
        _CACHE["pair"] = pair
        _CACHE["ev"] = ev.CloudEvaluator(
            B.pack_cloud_key(pair.main.cloud), pair.nbit
        )
    return _CACHE["pair"], _CACHE["ev"]


def _mul(avals, bvals, width):
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0x1DE, width])
    a = ev.encrypt_operand(pair.main, pair.nbit, avals, width,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, bvals, width,
                           prng.derive(s, 1))
    before = cloud.gate_count
    ans, info = cloud.compute(ev.OP_MUL, a, b)
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_MUL)
    return got, info, cloud.gate_count - before


def test_mul32_through_evaluator():
    """32x32 -> 64-bit product (mul32, `cloud.c:115-218`)."""
    avals = [123456789, 4000000000, -(2 ** 30)]
    bvals = [987654321, 3123456789, 2 ** 31 - 1]
    got, info, gates = _mul(avals, bvals, 32)
    assert got == [x * y for x, y in zip(avals, bvals)]
    assert info["out_width"] == 64
    # CSA count: 5W^2 + 2*pb*W per lane (BASELINE mul32 ~= 11.3k at
    # the reference's 5-gate adder; 5248 with the maj2 adder)
    pb = fused.ADDER_BOOTSTRAPS_PER_BIT[fused.adder_mode()]
    assert gates == fused.MUL_BOOTSTRAPS[fused.mul_mode()](32, pb) * 3


@pytest.mark.slow
def test_mul64_through_evaluator():
    """64x64 -> 128-bit product (mul64, `cloud.c:220-385`)."""
    avals = [2 ** 63 - 1, 0x123456789ABCDEF0]
    bvals = [2 ** 62 + 12345, -0xFEDCBA9876543210]
    got, info, gates = _mul(avals, bvals, 64)
    assert got == [x * y for x, y in zip(avals, bvals)]
    assert info["out_width"] == 128


@pytest.mark.slow
def test_mul128_through_evaluator():
    """128x128 -> 256-bit product (mul128, `cloud.c:387-647`)."""
    avals = [2 ** 127 - 1]
    bvals = [0x0123456789ABCDEF0123456789ABCDEF]
    got, info, gates = _mul(avals, bvals, 128)
    assert got == [avals[0] * bvals[0]]
    assert info["out_width"] == 256


def test_add_256bit_through_evaluator():
    """256-bit addition — the widest operand the reference encodes
    (8 x 32-bit limbs, `alice.c:72-110`); multiplication at this width
    is rejected (covered by test_mul_256bit_rejected)."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0x256])
    avals = [2 ** 255 - 987654321987654321, 2 ** 254 + 7]
    bvals = [987654321987654300, 2 ** 253 + 2 ** 200]
    a = ev.encrypt_operand(pair.main, pair.nbit, avals, 256,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, bvals, 256,
                           prng.derive(s, 1))
    ans, info = cloud.compute(ev.OP_ADD, a, b)
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_ADD)
    assert got == [(x + y) % 2 ** 256 for x, y in zip(avals, bvals)]
    assert info["width"] == 256

    # 256-bit subtraction crossing zero (two's complement at W=256)
    ans, _ = cloud.compute(ev.OP_SUB, b, a)
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB)
    assert got == [y - x for x, y in zip(avals, bvals)]


def test_fused_kogge_stone_evaluator():
    """The parallel-prefix adder as ONE dispatch through the evaluator
    (round-1 VERDICT: the unfused variant was dispatch-per-level)."""
    pair, _ = _setup()
    import ieache.boot.bootstrap as B2

    cloud = ev.CloudEvaluator(
        B2.pack_cloud_key(pair.main.cloud), pair.nbit,
        adder="kogge_stone",
    )
    s = prng.key_from_seed_words([0x6A])
    a = ev.encrypt_operand(pair.main, pair.nbit, [30, -7], 8,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [12, 5], 8,
                           prng.derive(s, 1))
    ans, _ = cloud.compute(ev.OP_SUB, a, b)
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB)
    assert got == [18, -12]
    assert cloud.gate_count > 0


def test_csa_equals_shift_multiplier():
    """Both multiplier circuits compute the same product."""
    from ieache.circuits import words

    pair, cloud = _setup()
    dck = cloud.dck
    s = prng.key_from_seed_words([0xCA5])
    avals, bvals, w = [13, 37, 255, 0], [9, 1, 255, 77], 8
    a = ev.encrypt_operand(pair.main, pair.nbit, avals, w,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, bvals, w,
                           prng.derive(s, 1))
    av, bv = a.value[:, :w, :], b.value[:, :w, :]
    want = [x * y for x, y in zip(avals, bvals)]
    got_csa = words.decrypt_word(
        pair.main, fused.schoolbook_mul_csa(av, bv, dck))
    got_shift = words.decrypt_word(
        pair.main, fused.schoolbook_mul_fused(av, bv, dck))
    assert got_csa == want
    assert got_shift == want
