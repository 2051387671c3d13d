import numpy as np

import ieache.boot.bootstrap as B
from ieache import params as P
from ieache.circuits import evaluator as ev
from ieache.lwe import keygen
from ieache.utils import prng

_CACHE = {}


def _setup():
    if "ks" not in _CACHE:
        pair = keygen.generate_gate_keypair(P.TEST_TINY)
        _CACHE["pair"] = pair
        _CACHE["dck"] = B.pack_cloud_key(pair.main.cloud)
        _CACHE["ev"] = ev.CloudEvaluator(_CACHE["dck"], pair.nbit)
    return _CACHE["pair"], _CACHE["ev"]


def _run(op, avals, bvals, width=8):
    pair, cloud = _setup()
    s = prng.key_from_seed_words([len(avals), op, width])
    a = ev.encrypt_operand(pair.main, pair.nbit, avals, width,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, bvals, width,
                           prng.derive(s, 1))
    ans, info = cloud.compute(op, a, b)
    return ev.decrypt_answer(pair.main, pair.nbit, ans, op), info


def test_add_all_sign_cases():
    got, _ = _run(ev.OP_ADD, [3, 9], [5, 100])
    assert got == [8, 109]
    got, _ = _run(ev.OP_ADD, [-3, -9], [-5, -100])
    assert got == [-8, -109]
    got, _ = _run(ev.OP_ADD, [-3, -100], [5, 9])
    assert got == [2, -91]
    got, _ = _run(ev.OP_ADD, [3, 9], [-5, -2])
    assert got == [-2, 7]


def test_sub_all_sign_cases():
    got, _ = _run(ev.OP_SUB, [7, 3], [3, 7])
    assert got == [4, -4]
    got, _ = _run(ev.OP_SUB, [-7, -1], [3, 9])
    assert got == [-10, -10]
    got, _ = _run(ev.OP_SUB, [7, 2], [-3, -9])
    assert got == [10, 11]
    got, _ = _run(ev.OP_SUB, [-7, -9], [-3, -2])
    assert got == [-4, -7]


def test_mul_all_sign_cases():
    got, info = _run(ev.OP_MUL, [3, 11], [5, 13])
    assert got == [15, 143]
    assert info["out_width"] == 16
    got, _ = _run(ev.OP_MUL, [-3, -11], [5, 13])
    assert got == [-15, -143]
    got, _ = _run(ev.OP_MUL, [3, 11], [-5, -13])
    assert got == [-15, -143]
    got, _ = _run(ev.OP_MUL, [-3, -11], [-5, -13])
    assert got == [15, 143]


def test_opcode_3_is_multiply():
    """The reference's orchestrator writes "4" to operator.txt for
    both opcode 3 and 4 (`dragonfly_cipher_cloud.py:1256-1273`; the
    ACCC paper uses 3 for multiply) — accept 3 as mul everywhere."""
    got, info = _run(3, [3, -11], [5, 13])
    assert got == [15, -143]
    assert info["out_width"] == 16


def test_widths_differ_takes_max():
    """Operands with different declared bit counts: result width is
    max(bit1, bit2) (`cloud.c:832-855`), and the narrower operand's
    upper bits read as encrypted zeros."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0x3D])
    a = ev.encrypt_operand(pair.main, pair.nbit, [200, 90], 8,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [3000, 1500], 12,
                           prng.derive(s, 1))
    ans, info = cloud.compute(ev.OP_ADD, a, b)
    assert info["width"] == 12 and info["out_width"] == 12
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_ADD)
    assert got == [3200, 1590]

    # subtraction crossing zero: the answer is two's complement at the
    # operand width, so |result| must fit width-1 bits — the same
    # representational bound as the reference (`verif.c:132-166`
    # reconstructs with the width-w two's-complement heuristic).
    b2 = ev.encrypt_operand(pair.main, pair.nbit, [1800, 1500], 12,
                            prng.derive(s, 2))
    ans, _ = cloud.compute(ev.OP_SUB, a, b2)
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB)
    assert got == [200 - 1800, 90 - 1500]


def test_mul_widths_differ_doubles_max():
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0x3E])
    a = ev.encrypt_operand(pair.main, pair.nbit, [9, 13], 4,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [200, 3], 8,
                           prng.derive(s, 1))
    ans, info = cloud.compute(ev.OP_MUL, a, b)
    assert info["out_width"] == 16
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_MUL)
    assert got == [1800, 39]


def test_mul_256bit_rejected():
    pair, cloud = _setup()
    s = prng.key_from_seed_words([1])
    a = ev.encrypt_operand(pair.main, pair.nbit, [1], 256,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [1], 256,
                           prng.derive(s, 1))
    try:
        cloud.compute(ev.OP_MUL, a, b)
        assert False, "expected MulWidthError"
    except ev.MulWidthError:
        pass


def test_mixed_sign_batch_per_lane():
    """A batch mixing ALL four sign combinations must decrypt to the
    correct per-lane values (the reference's per-run sign branch,
    `cloud.c:780-827`, generalized per lane; round-1 VERDICT flagged
    lane-0 metadata as a silent-wrong-answer hazard)."""
    a_vals = [3, -3, 3, -3, 9, -100]
    b_vals = [5, 5, -5, -5, -2, 5]
    got, info = _run(ev.OP_ADD, a_vals, b_vals)
    assert got == [x + y for x, y in zip(a_vals, b_vals)]
    assert set(info["neg_codes"]) == {0, 1, 2, 4}
    got, _ = _run(ev.OP_SUB, a_vals, b_vals)
    assert got == [x - y for x, y in zip(a_vals, b_vals)]
    am = [3, -3, 3, -3, 9, -10]
    bm = [5, 5, -5, -5, -2, 5]
    got, _ = _run(ev.OP_MUL, am, bm, width=4)
    assert got == [x * y for x, y in zip(am, bm)]


def test_mixed_sign_chained_answer():
    """Chained answers carry per-lane codes in {0,1,2,4}; feeding a
    mixed-code answer back as an operand must stay per-lane correct."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0x51])
    a = ev.encrypt_operand(pair.main, pair.nbit, [3, -3], 8,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [5, -5], 8,
                           prng.derive(s, 1))
    c = ev.encrypt_operand(pair.main, pair.nbit, [7, 2], 8,
                           prng.derive(s, 2))
    ab, info = cloud.compute(ev.OP_ADD, a, b)     # [8 (code 0), -8 (code 4)]
    assert set(info["neg_codes"]) == {0, 4}
    abc, _ = cloud.compute(ev.OP_ADD, ab, c)
    got = ev.decrypt_answer(pair.main, pair.nbit, abc, ev.OP_ADD)
    assert got == [8 + 7, -8 + 2]


def test_invalid_negativity_code_rejected():
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0x52])
    a = ev.encrypt_operand(pair.main, pair.nbit, [3], 8,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [5], 8,
                           prng.derive(s, 1))
    # corrupt A's negativity word to an undefined code (3)
    from ieache.circuits import words as W
    from ieache.lwe import encrypt as enc
    import jax.numpy as jnp

    bad = jnp.asarray(enc.encrypt_bits(
        pair.nbit, W.values_to_bits([3], ev.META_WIDTH),
        prng.derive(s, 3),
    ))
    a = ev.Operand(bad, a.bit_word, a.value, a.carry_word)
    try:
        cloud.compute(ev.OP_ADD, a, b)
        assert False, "expected ValueError"
    except ValueError:
        pass


def test_compute_chain_matches_sequential():
    """compute_chain (one dispatch) must be observably equivalent to
    sequential compute() calls, including mixed per-lane signs."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0xC4A])
    # intermediate codes stay in {0, 4} (magnitude representations) so
    # true-math assertions hold; chained {1, 2}-code intermediates are
    # a reference representation hazard covered below
    a_vals, b_vals, c_vals = [3, -9, 7], [5, -5, 2], [10, -4, 6]
    ops3 = [ev.OP_ADD, ev.OP_SUB]

    def enc(vals, i, w=8):
        return ev.encrypt_operand(pair.main, pair.nbit, vals, w,
                                  prng.derive(s, i))

    a, b, c = enc(a_vals, 0), enc(b_vals, 1), enc(c_vals, 2)
    ab, _ = cloud.compute(ops3[0], a, b)
    seq, _ = cloud.compute(ops3[1], ab, c)
    want = ev.decrypt_answer(pair.main, pair.nbit, seq, ops3[1])

    chained, info = cloud.compute_chain(ops3, [a, b, c])
    got = ev.decrypt_answer(pair.main, pair.nbit, chained, ops3[1])
    assert got == want
    assert want == [x + y - z
                    for x, y, z in zip(a_vals, b_vals, c_vals)]

    # with a multiply as the final op: (A - B) * C
    am, bm, cm = enc([6, 8], 3, 4), enc([2, 3], 4, 4), enc([5, -7], 5, 4)
    ab2, _ = cloud.compute(ev.OP_SUB, am, bm)
    seq2, _ = cloud.compute(ev.OP_MUL, ab2, cm)
    want2 = ev.decrypt_answer(pair.main, pair.nbit, seq2, ev.OP_MUL)
    ch2, _ = cloud.compute_chain([ev.OP_SUB, ev.OP_MUL], [am, bm, cm])
    got2 = ev.decrypt_answer(pair.main, pair.nbit, ch2, ev.OP_MUL)
    assert got2 == want2 == [(6 - 2) * 5, (8 - 3) * -7]


def test_compute_steps_mul_first_tree():
    """A - B*C (postfix ABC*-): the multiply-first tree the reference
    CLI produces, as one compiled circuit — matches sequential and
    true math (operands stay magnitudes; only the final sub crosses
    zero, which decrypts signed)."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0xABC])

    def enc(vals, i):
        return ev.encrypt_operand(pair.main, pair.nbit, vals, 8,
                                  prng.derive(s, i))

    a_vals, b_vals, c_vals = [7, 100, 3], [3, 5, 9], [2, 9, 8]
    a, b, c = enc(a_vals, 0), enc(b_vals, 1), enc(c_vals, 2)
    bc, _ = cloud.compute(ev.OP_MUL, b, c)
    seq, _ = cloud.compute(ev.OP_SUB, a, bc)
    want = ev.decrypt_answer(pair.main, pair.nbit, seq, ev.OP_SUB)

    steps = [(ev.OP_MUL, ("opnd", 1), ("opnd", 2)),
             (ev.OP_SUB, ("opnd", 0), ("step", 0))]
    ch, info = cloud.compute_steps(steps, [a, b, c])
    got = ev.decrypt_answer(pair.main, pair.nbit, ch, ev.OP_SUB)
    assert got == want == [x - y * z for x, y, z in
                           zip(a_vals, b_vals, c_vals)]
    assert info["out_width"] == 16


def test_compute_chain_exact_on_representation_hazard_lanes():
    """Sign-ambiguous intermediates (e.g. pos+neg, where the true sign
    depends on the VALUES) are a representation hazard in the
    reference: its chained answers re-import PREDICTED sign codes
    (`cloud.c:780-827` + `verif.c:132-166`), so per-op sequential
    chaining mis-signs such lanes.  The r5 chain redesign stores
    ADD/SUB intermediates as raw two's complement (no sign claim), so
    the whole-chain path is EXACT on every lane — better than the
    reference and than per-op chaining, whose reference-parity
    behavior is documented below."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0xC4B])

    def enc(vals, i, w=8):
        return ev.encrypt_operand(pair.main, pair.nbit, vals, w,
                                  prng.derive(s, i))

    # lane 1: -9+5 (sign-ambiguous intermediate); lane 2: 7+(-2)
    a, b, c = enc([3, -9, 7], 0), enc([5, 5, -2], 1), enc([10, -4, 6], 2)
    chained, _ = cloud.compute_chain([ev.OP_ADD, ev.OP_SUB], [a, b, c])
    got = ev.decrypt_answer(pair.main, pair.nbit, chained, ev.OP_SUB)
    assert got == [3 + 5 - 10, -9 + 5 - (-4), 7 + (-2) - 6]  # exact

    # the per-op sequential path keeps the reference's predicted-code
    # semantics: ambiguous lanes mis-sign exactly as the reference's
    # chained ./cloud runs would (documented parity hazard)
    ab, _ = cloud.compute(ev.OP_ADD, a, b)
    seq, _ = cloud.compute(ev.OP_SUB, ab, c)
    seq_vals = ev.decrypt_answer(pair.main, pair.nbit, seq, ev.OP_SUB)
    assert seq_vals[0] == 3 + 5 - 10  # unambiguous lane still exact


def test_chained_answer_zero_extends_to_wider_operand():
    """A narrow chained answer meeting a wider third operand must
    zero-extend (the answer keeps only out_width bits in memory; the
    reference's on-disk answers are always 8 slots, cloud.c:899-916)."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0xE7])
    a = ev.encrypt_operand(pair.main, pair.nbit, [3, 4], 4,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [5, 6], 4,
                           prng.derive(s, 1))
    c = ev.encrypt_operand(pair.main, pair.nbit, [200, 100], 8,
                           prng.derive(s, 2))
    ab, info = cloud.compute(ev.OP_ADD, a, b)       # 4-bit answer
    assert info["out_width"] == 4
    abc, _ = cloud.compute(ev.OP_ADD, ab, c)        # widened to 8
    got = ev.decrypt_answer(pair.main, pair.nbit, abc, ev.OP_ADD)
    assert got == [3 + 5 + 200, 4 + 6 + 100]


def test_answer_chains_as_operand():
    """answer layout == operand layout (compute_final chaining,
    dragonfly_cipher_cloud.py:1300-1327)."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([2])
    a = ev.encrypt_operand(pair.main, pair.nbit, [3, 4], 8,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [5, 6], 8,
                           prng.derive(s, 1))
    c = ev.encrypt_operand(pair.main, pair.nbit, [7, 8], 8,
                           prng.derive(s, 2))
    ab, _ = cloud.compute(ev.OP_ADD, a, b)
    abc, _ = cloud.compute(ev.OP_ADD, ab, c)
    got = ev.decrypt_answer(pair.main, pair.nbit, abc, ev.OP_ADD)
    assert got == [3 + 5 + 7, 4 + 6 + 8]


def test_mul_mul_chain_asymmetric_widths():
    """A*B*C via compute_steps: the second multiply is (2W)x(W) — the
    r4 asymmetric windowed-CSA path (rounds over the narrower operand)
    must decrypt exactly and account fewer gates than symmetric."""
    from ieache.circuits import fused as fz

    pair, cloud = _setup()
    s = prng.key_from_seed_words([0x77])
    a = ev.encrypt_operand(pair.main, pair.nbit, [5, 7], 4,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [6, 3], 4,
                           prng.derive(s, 1))
    c = ev.encrypt_operand(pair.main, pair.nbit, [10, 2], 4,
                           prng.derive(s, 2))
    g0 = cloud.gate_count
    ans, info = cloud.compute_steps(
        [(ev.OP_MUL, ("opnd", 0), ("opnd", 1)),
         (ev.OP_MUL, ("step", 0), ("opnd", 2))],
        [a, b, c],
    )
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_MUL)
    assert got == [300, 42]
    pb = fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()]
    want_gates = (fz._csa_bootstraps_xy(4, 4, pb)
                  + fz._csa_bootstraps_xy(8, 4, pb)) * 2
    assert cloud.gate_count - g0 == want_gates


def test_chain_memory_analysis_reports_xla_accounting():
    """The AOT memory audit (VERDICT r4 #6's safe probe for
    worker-faulting shapes) lowers+compiles WITHOUT executing and
    returns XLA's byte accounting."""
    p = P.TEST_TINY
    pair = keygen.generate_gate_keypair(p)
    dck = B.pack_cloud_key(pair.main.cloud)
    s = prng.key_from_seed_words([0xAD])
    ops = [
        ev.encrypt_operand(pair.main, pair.nbit, [3, 5], 8,
                           prng.derive(s, i))
        for i in range(3)
    ]
    cloud = ev.CloudEvaluator(dck, pair.nbit)
    steps = [(ev.OP_MUL, ("opnd", 0), ("opnd", 1)),
             (ev.OP_SUB, ("step", 0), ("opnd", 2))]
    before = cloud.gate_count
    ma = cloud.chain_memory_analysis(steps, ops)
    assert cloud.gate_count == before      # audit never counts gates
    assert ma["temp_size_in_bytes"] > 0
    assert ma["argument_size_in_bytes"] > 0
    assert ma["peak_bytes_estimate"] >= ma["temp_size_in_bytes"]


def test_chain_honors_kogge_stone_adder():
    """The whole-chain executor runs the parallel-prefix adder when the
    evaluator selects kogge_stone (r5 fix: the chain previously ran
    ripple regardless, invalidating adder comparisons) — results match
    ripple bit-for-bit at the plaintext level and the gate count is the
    exact KS count, not the ripple count."""
    p = P.TEST_TINY
    pair = keygen.generate_gate_keypair(p)
    dck = B.pack_cloud_key(pair.main.cloud)
    s = prng.key_from_seed_words([0xAC])
    rng = np.random.RandomState(5)
    av, bv, cv = (rng.randint(1, 60, 4) for _ in range(3))
    ops = [
        ev.encrypt_operand(pair.main, pair.nbit, v, 8, prng.derive(s, i))
        for i, v in enumerate((av, bv, cv))
    ]
    want = [int(x) + int(y) - int(z) for x, y, z in zip(av, bv, cv)]
    counts = {}
    for adder in ("ripple", "kogge_stone"):
        cloud = ev.CloudEvaluator(dck, pair.nbit, adder=adder)
        ans, _ = cloud.compute_chain([ev.OP_ADD, ev.OP_SUB], ops)
        got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB)
        assert got == want, adder
        counts[adder] = cloud.gate_count
    # exact per-lane KS count at W=8: 3*8 + 3*(8+7+5+1) = 87 per op
    # the fused 3-term path (r5): 3w compression + ONE prefix add
    assert counts["kogge_stone"] == (3 * 8 + 87) * 4
    assert counts["ripple"] == 2 * 8 * 2 * 4  # maj2: 2 boots/bit


def test_chain_widening_per_lane_extension():
    """Widening a chain intermediate must extend PER LANE: magnitude
    (pure) lanes zero-extend even with the MSB set, signed (impure)
    lanes sign-extend — a single per-side choice corrupts one or the
    other (r5 review finding: 7+7=14 at w=4 widened signed read 254)."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0xD1])
    a = ev.encrypt_operand(pair.main, pair.nbit, [7, 3], 4,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [7, -6], 4,
                           prng.derive(s, 1))
    c = ev.encrypt_operand(pair.main, pair.nbit, [100, 100], 8,
                           prng.derive(s, 2))
    ans, _ = cloud.compute_chain([ev.OP_ADD, ev.OP_ADD], [a, b, c])
    got = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_ADD)
    # lane 0: pure magnitude 14 (MSB set at w=4) -> zero-extend;
    # lane 1: signed -3 -> sign-extend
    assert got == [7 + 7 + 100, 3 - 6 + 100]


def test_code5_answer_reimports_as_operand():
    """A chained answer carrying the r5 code 5 (negated two's
    complement) must be accepted when fed back as an operand (the
    cross-job chaining flow, cloud.c:798-827); its re-import keeps the
    reference's magnitude heuristic, so only the no-crash contract and
    the unambiguous lane are asserted."""
    pair, cloud = _setup()
    s = prng.key_from_seed_words([0xD2])
    a = ev.encrypt_operand(pair.main, pair.nbit, [3, -9], 8,
                           prng.derive(s, 0))
    b = ev.encrypt_operand(pair.main, pair.nbit, [5, 5], 8,
                           prng.derive(s, 1))
    c = ev.encrypt_operand(pair.main, pair.nbit, [10, -4], 8,
                           prng.derive(s, 2))
    ans, info = cloud.compute_chain([ev.OP_ADD, ev.OP_SUB], [a, b, c])
    assert 5 in info["neg_codes"]
    # in-job decryption of the code-5 answer is exact
    direct = ev.decrypt_answer(pair.main, pair.nbit, ans, ev.OP_SUB)
    assert direct == [3 + 5 - 10, -9 + 5 - (-4)]
    d = ev.encrypt_operand(pair.main, pair.nbit, [1, 1], 8,
                           prng.derive(s, 3))
    # re-import must not raise; its VALUE semantics follow the
    # reference's magnitude heuristic (answer/operand code vocabulary
    # collisions predate r5 — documented hazard, verif.c:132-166)
    cloud.compute(ev.OP_ADD, ans, d)
