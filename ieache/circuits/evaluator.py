"""The Cloud evaluator: multi-precision signed expression operations.

Counterpart of the reference evaluator binary's ``main``
dispatch (``/root/reference/Cloud/cloud.c:650-2720``, component C10).
Replicates its observable semantics:

* operands arrive as **magnitude + metadata**: a negativity word and a
  bit-count word encrypted under the *nbit* keyset, value limbs and a
  zero carry word under the *main* keyset
  (``Client1/alice.c:116-191`` layout, LSB-first bits, LSW-first limbs);
* the evaluator **decrypts the metadata** with the nbit secret key it
  holds — width/sign are cleartext-to-evaluator by design
  (``cloud.c:710-713,780-795``; SURVEY Appendix A);
* negativity codes: operand code 2 means negative (``process.c:80-93``);
  combined code written to the answer is {0:0, 1:1, 2:2, 3:4}
  (``cloud.c:798-827``);
* result width: ``max(bit1, bit2)``, doubled for multiplication
  (``cloud.c:832-855``); multiplying >=256-bit operands raises
  (exit-126 guard, ``cloud.c:860-864``);
* dispatch (``cloud.c:870,1194,2368``):
  - magnitude add: (add & signs equal) or (sub & exactly one negative)
  - A + twos(B): (sub & none negative) or (add & only B negative)
  - B + twos(A): (sub & both negative) or (add & only A negative)
  - mul: schoolbook magnitude product
* the answer mirrors the operand layout (neg, bit, 8 value words,
  carry) so chained expressions can feed it back as an operand
  (``dragonfly_cipher_cloud.py:1300-1327``).  Deviation from the
  reference: value limbs are always LSW-first (the reference's
  multiply paths scatter limbs in an op-dependent order that its own
  verif compensates — SURVEY Appendix A; we keep one canonical order
  on both sides instead).

Batching: one Operand holds B expressions with shared (op, widths,
signs) — the reference evaluates one expression per process, this
framework evaluates thousands per bootstrap batch.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import jax.numpy as jnp

from ieache.boot import gates
from ieache.boot.bootstrap import DeviceCloudKey
from ieache.circuits import arith, words
from ieache.lwe import encrypt
from ieache.lwe.types import SecretKeySet
from ieache.utils import prng

#: operation codes as written to operator.txt by the Output CLI
#: (`output_dynamic.py:1115-1124`: + -> 1, - -> 2, * and / -> 4)
OP_ADD, OP_SUB, OP_MUL = 1, 2, 4

#: operand layout constants (alice.c:166-191): 8 value limb slots
VALUE_SLOTS = 8
META_WIDTH = 32


class MulWidthError(Exception):
    """256-bit multiplication rejection (`cloud.c:860-864`, exit 126)."""


@dataclasses.dataclass
class Operand:
    """One batched operand in the reference wire layout."""

    neg_word: jnp.ndarray    # (B, 32, n_nbit+1) under nbit key
    bit_word: jnp.ndarray    # (B, 32, n_nbit+1) under nbit key
    value: jnp.ndarray       # (B, 256, n+1) under main key (8 limbs x 32)
    carry_word: jnp.ndarray  # (B, 32, n+1) encrypted zeros under main key

    @property
    def batch(self) -> int:
        return self.neg_word.shape[0]


def encrypt_operand(
    main_ks: SecretKeySet,
    nbit_ks: SecretKeySet,
    values,
    width: int,
    stream,
) -> Operand:
    """Client-side operand encryption (alice semantics, C3).

    `values` are signed python ints; magnitude is encrypted, sign goes
    to the negativity word (code 2 = negative, `process.c:80-93`).
    """
    values = [int(v) for v in values]
    negs = [2 if v < 0 else 0 for v in values]
    mags = [abs(v) for v in values]
    if any(m >= (1 << width) for m in mags):
        raise ValueError(f"magnitude does not fit {width} bits")
    neg_word = jnp.asarray(
        encrypt.encrypt_bits(
            nbit_ks,
            words.values_to_bits(negs, META_WIDTH),
            prng.derive(stream, 0),
        )
    )
    bit_word = jnp.asarray(
        encrypt.encrypt_bits(
            nbit_ks,
            words.values_to_bits([width] * len(values), META_WIDTH),
            prng.derive(stream, 1),
        )
    )
    value = jnp.asarray(
        encrypt.encrypt_bits(
            main_ks,
            words.values_to_bits(mags, VALUE_SLOTS * 32),
            prng.derive(stream, 2),
        )
    )
    carry = jnp.asarray(
        encrypt.encrypt_bits(
            main_ks,
            np.zeros((len(values), 32), np.int32),
            prng.derive(stream, 3),
        )
    )
    return Operand(neg_word, bit_word, value, carry)


def _decrypt_meta_value(nbit_ks: SecretKeySet, word) -> np.ndarray:
    bits = encrypt.decrypt_bits(nbit_ks, word)
    return np.asarray(words.bits_to_values(bits), np.int64)


def _normalized_neg(neg: np.ndarray) -> np.ndarray:
    """Negativity code -> 0/1 per lane.  Operand codes: 2 from clients
    (`process.c:80-93`); 1/2/4 when a chained answer is fed back as an
    operand (`cloud.c:798-827`), plus the r5 code 5 (negated two's
    complement) — all normalize to "is negative".  Cross-JOB re-import
    of sign-ambiguous answers (codes 1/2/5) keeps the reference's
    magnitude heuristic (`verif.c:132-166`); in-job chains bypass
    codes entirely and are exact."""
    bad = set(neg.tolist()) - {0, 1, 2, 4, 5}
    if bad:
        raise ValueError(f"invalid negativity codes: {bad}")
    return np.isin(neg, (1, 2, 4, 5)).astype(np.int64)


def _sign_plan(op: int, combined: np.ndarray):
    """Per-lane dataflow selection for add/sub (`cloud.c:870-2367`):
    returns (swap, comp) — swap exchanges the operands, comp runs
    X + NOT(Y) + 1 instead of the magnitude add X + Y."""
    if op == OP_ADD:
        # magnitude add lanes: A+B, (-A)+(-B); swap when only A is
        # negative ((-A)+B = B - A)
        mag = (combined == 0) | (combined == 3)
        swap = combined == 1
    elif op == OP_SUB:
        # magnitude add lanes: A-(-B), (-A)-B; swap when both negative
        # ((-A)-(-B) = B - A)
        mag = (combined == 1) | (combined == 2)
        swap = combined == 3
    else:  # mul: magnitude product, signs live in the answer code
        mag = np.ones_like(combined, bool)
        swap = np.zeros_like(combined, bool)
    return swap, ~mag


def _take_width(val: jnp.ndarray, width: int, n: int) -> jnp.ndarray:
    """Slice a value word to `width` bits, zero-extending with trivial
    LWE(0) rows if it stores fewer (a chained answer keeps only
    out_width bits in memory; the reference's answers are padded to 8
    slots on disk, `cloud.c:899-916`, so its chained operands are
    always wide enough — ours must extend explicitly)."""
    have = val.shape[1]
    if have >= width:
        return val[:, :width, :]
    pad = gates.CONSTANT(
        jnp.zeros((val.shape[0], width - have), jnp.int32), n
    )
    return jnp.concatenate([val, pad], axis=1)


def _take_width_lane(val: jnp.ndarray, width: int, n: int,
                     sext) -> jnp.ndarray:
    """Per-LANE width extension for chain intermediates: lanes whose
    bits are a signed two's complement (sext=1, the planner's impure
    lanes) replicate the top bit — sign extension is free, ciphertext
    rows copy — while magnitude lanes (pure, decoded unsigned) zero-
    extend.  A single per-side choice is WRONG both ways: r5 review
    found zero-extension corrupting negative two's-complement lanes
    and sign-extension corrupting MSB-set magnitudes (7+7=14 at w=4
    widened to 8 read 254)."""
    have = val.shape[1]
    if have >= width:
        return val[:, :width, :]
    zeros = gates.CONSTANT(
        jnp.zeros((val.shape[0], width - have), jnp.int32), n
    )
    if sext is None:
        pad = zeros
    else:
        top = jnp.broadcast_to(
            val[:, have - 1:have, :],
            (val.shape[0], width - have, val.shape[2]),
        )
        pad = jnp.where(sext[:, None, None] == 1, top, zeros)
    return jnp.concatenate([val, pad], axis=1)


def _csa3_fusable(plan) -> bool:
    """True when the plan is the pure-add 3-operand left fold
    ``(o0 ± o1) ± o2`` with equal step widths — the shape the fused
    carry-free 3:2 compression + single parallel-prefix add serves
    (the A+B+C / A+B-C / A-B-C Fig.7 expressions).  Equal widths are
    required because the serial chain truncates mod 2^w after step 1;
    with w1 == w2 the single mod-2^w reduction is identical."""
    if len(plan) != 2:
        return False
    (op1, wl1, wr1, ow1, lhs1, rhs1) = plan[0][:6]
    (op2, wl2, wr2, ow2, lhs2, rhs2) = plan[1][:6]
    return (
        op1 in (OP_ADD, OP_SUB) and op2 in (OP_ADD, OP_SUB)
        and lhs1 == ("opnd", 0) and rhs1 == ("opnd", 1)
        and lhs2 == ("step", 0) and rhs2 == ("opnd", 2)
        and ow1 == ow2
    )


def _kogge_count(w: int) -> int:
    """Exact bootstraps per lane of one W-bit parallel-prefix add
    (single source of truth: circuits.fused)."""
    from ieache.circuits import fused as fz

    return fz._kogge_count_fz(w)


@functools.partial(jax.jit, static_argnames=("plan", "amode", "mmode"))
def _chain_exec(dck, vals, comps, sexts, plan, amode, mmode):
    """Execute a planned expression DAG inside one trace.

    plan (static): tuple of (op, wl, wr, ow, lhs, rhs, kinds) per
    step, where lhs/rhs reference either an input operand
    ("opnd", i) or an earlier step's output ("step", j).  vals are
    the operand value words; comps the per-step per-lane rhs
    complement masks (the lhs is never complemented — the planner's
    negflag folding guarantees it); sexts the per-step per-lane
    sign-extension masks consulted when a later, wider step consumes
    that step's output (impure lanes sign-extend, magnitude lanes
    zero-extend).
    """
    from ieache.circuits import fused as fz

    n = dck.params.n

    if amode == "kogge" and _csa3_fusable(plan):
        # fused 3-term add: one carry-free 3:2 compression + ONE
        # parallel-prefix add (~14 serial waves at W=16 vs 24 for the
        # chained pair) — the r5 latency path.  With the negflag-
        # folded planning the dataflow is uniformly
        # a + (b ~ cm1) + (c ~ cm2) + cm1 + cm2; the cleartext
        # constant rides as two unit carries.
        w = plan[1][3]
        a3 = _take_width(vals[0], w, n)
        b3 = _take_width(vals[1], w, n)
        c3 = _take_width(vals[2], w, n)
        cm1 = comps[0].astype(jnp.int32)
        cm2 = comps[1].astype(jnp.int32)
        k_const = cm1 + cm2
        bw_ = jnp.where(cm1[:, None, None] == 1,
                        arith.not_word(b3), b3)
        cw_ = jnp.where(cm2[:, None, None] == 1,
                        arith.not_word(c3), c3)
        out3, _ = fz.csa3_add(
            a3, bw_, cw_,
            (k_const >= 1).astype(jnp.int32),
            (k_const >= 2).astype(jnp.int32), dck,
        )
        return out3

    outs = []

    def val_of(ref):
        kind, i = ref
        return vals[i] if kind == "opnd" else outs[i]

    def ext_of(ref):
        return None if ref[0] == "opnd" else sexts[ref[1]]

    for k, step in enumerate(plan):
        (op, wl, wr, ow, lhs, rhs) = step[:6]
        if op == OP_MUL and mmode == "csa":
            # width-asymmetric multiply: each side at its true width,
            # rounds over the narrower operand (magnitude semantics:
            # zero-extension)
            x = _take_width(val_of(lhs), wl, n)
            bv = _take_width(val_of(rhs), wr, n)
            if wr > wl:
                x, bv = bv, x
            cur = fz.schoolbook_mul_csa(x, bv, dck,
                                        latency=(amode == "kogge"))
            outs.append(cur)
            continue
        w = max(wl, wr)
        if op == OP_MUL:
            x = _take_width(val_of(lhs), w, n)
            bv = _take_width(val_of(rhs), w, n)
            cur = fz.schoolbook_mul_fused(x, bv, dck)
        else:
            x = _take_width_lane(val_of(lhs), w, n, ext_of(lhs))
            bv = _take_width_lane(val_of(rhs), w, n, ext_of(rhs))
            cm = comps[k][:, None, None]
            y = jnp.where(cm, arith.not_word(bv), bv)
            ci = gates.CONSTANT(comps[k].astype(jnp.int32), n)
            if amode == "kogge":
                # parallel-prefix adder: O(log W) serial waves — the
                # small-batch latency adder (r5: the chain path never
                # honored the evaluator's kogge_stone selection before,
                # so the r4 'KS is neutral' comparison measured the
                # ripple path twice)
                cur, _ = fz.kogge_stone_add(x, y, dck, ci)
            else:
                cur, _ = fz.ripple_add(x, y, ci, dck, amode)
        outs.append(cur)
    return outs[-1]


class CloudEvaluator:
    """Holds the evaluation keys and runs one (op, A, B) computation."""

    def __init__(self, main_dck: DeviceCloudKey, nbit_ks: SecretKeySet,
                 adder: str = "ripple", fused: bool = True):
        self.dck = main_dck
        self.nbit_ks = nbit_ks
        if adder not in ("ripple", "kogge_stone"):
            raise ValueError(adder)
        self.adder = adder
        #: fused=True evaluates each whole op in one jit dispatch
        #: (circuits/fused.py) — essential when device dispatch has
        #: per-call latency.
        self.fused = fused
        self.gate_count = 0

    # -- helpers -----------------------------------------------------------
    def _add(self, x, y, carry_in):
        b, w = x.shape[0], x.shape[1]
        if self.adder == "kogge_stone":
            if self.fused:
                from ieache.circuits import fused as fz

                s, c = fz.kogge_stone_add(x, y, self.dck, carry_in)
            else:
                s, c = arith.kogge_stone_add(x, y, self.dck,
                                             carry_in=carry_in)
            # 2 p/g + 1 sum bootstraps per bit, + 3 per combine lane
            count, we, dist = 3 * w, w + 1, 1
            while dist < we:
                count += 3 * (we - dist)
                dist *= 2
            self.gate_count += count * b
            return s, c
        per_bit = 5
        if self.fused:
            from ieache.circuits import fused as fz

            s, c = fz.ripple_add(x, y, carry_in, self.dck)
            per_bit = fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()]
        else:
            s, c = arith.ripple_add(x, y, carry_in, self.dck)
        self.gate_count += per_bit * w * b
        return s, c

    # -- the dispatch ------------------------------------------------------
    def compute(self, op: int, a: Operand, b: Operand):
        """Returns (answer Operand, info dict) — `cloud.c:650-2720`.

        Sign handling is **per lane**: the reference evaluates one
        expression per ./cloud run and branches on its (op, signs) case
        (`cloud.c:870,1194,2368`); a batch here may mix sign
        combinations.  Because negativity metadata is cleartext to the
        evaluator by design, lane dataflow selection is a host-side
        `jnp.where` over the three add/sub dataflows:

            X + Y            (magnitude add)
            X + NOT(Y) + 1   (two's-complement subtract)

        with the operand swap and the ``+1`` riding the adder's
        per-lane carry-in — every lane is correct and the whole batch
        still runs as ONE fused adder dispatch (zero extra bootstraps;
        in fact one fewer add than the reference's NOT-then-add-one-
        then-add two's complement, `cloud.c:1225-1245`).
        """
        if op == 3:
            # the reference's orchestrator writes "4" to operator.txt
            # for both opcode 3 and 4 (dragonfly_cipher_cloud.py:
            # 1256-1273; the ACCC paper uses 3 for multiply)
            op = OP_MUL
        nbit = self.nbit_ks
        neg1 = _decrypt_meta_value(nbit, a.neg_word)
        neg2 = _decrypt_meta_value(nbit, b.neg_word)
        bit1 = _decrypt_meta_value(nbit, a.bit_word)
        bit2 = _decrypt_meta_value(nbit, b.bit_word)

        width = int(max(bit1.max(), bit2.max()))

        # cloud.c:787-804: combined negativity in {0,1,2,3}
        # (0 = none, 1 = A negative, 2 = B negative, 3 = both).
        combined = _normalized_neg(neg1) + 2 * _normalized_neg(neg2)
        answer_codes = np.array([0, 1, 2, 4])[combined]

        out_width = width
        if op == OP_MUL:
            if width >= 256:
                raise MulWidthError(
                    "Cannot multiply 256 bit number!"
                )  # cloud.c:860-864
            out_width = 2 * width

        batch = a.batch
        n = self.dck.params.n
        wa, wb = int(bit1.max()), int(bit2.max())
        av = _take_width(a.value, width, n)
        bv = _take_width(b.value, width, n)

        if op == OP_MUL:
            # magnitude product; per-lane signs live in the answer code
            if self.fused:
                from ieache.circuits import fused as fz

                mode = fz.mul_mode()
                if mode == "csa":
                    # width-asymmetric: each operand at its true nbit
                    # width (rounds scan the narrower one) — the
                    # reference's own cleartext width dispatch
                    xv = _take_width(a.value, wa, n)
                    yv = _take_width(b.value, wb, n)
                    if wb > wa:
                        xv, yv = yv, xv
                    result = fz.schoolbook_mul_csa(xv, yv, self.dck)
                    self.gate_count += fz._csa_bootstraps_xy(
                        max(wa, wb), min(wa, wb),
                        fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()],
                    ) * batch
                else:
                    result = fz.schoolbook_mul_fused(av, bv, self.dck)
                    pb = fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()]
                    self.gate_count += (
                        fz.MUL_BOOTSTRAPS[mode](width, pb) * batch
                    )
            else:
                result = arith.schoolbook_mul(av, bv, self.dck, out_width)
                # W rounds x (W ANDs + one 2W-bit add at 5 gates/bit)
                self.gate_count += (1 + 2 * 5) * width * width * batch
        elif op in (OP_ADD, OP_SUB):
            swap, comp = _sign_plan(op, combined)
            swap_j = jnp.asarray(swap)[:, None, None]
            x = jnp.where(swap_j, bv, av)
            y = jnp.where(swap_j, av, bv)
            comp_j = jnp.asarray(comp)[:, None, None]
            y = jnp.where(comp_j, arith.not_word(y), y)
            carry_in = gates.CONSTANT(
                jnp.asarray(comp, jnp.int32), n
            )
            result, _ = self._add(x, y, carry_in)
        else:
            raise ValueError(f"bad op {op}")

        return self._finish_answer(op, width, out_width, answer_codes,
                                   combined, result, a.carry_word)

    def _finish_answer(self, op, width, out_width, answer_codes,
                       combined, result, carry_word):
        """Answer metadata (fresh nbit encryptions, cloud.c:808-855).

        The answer's value carries exactly out_width bits in memory;
        the 8-slot carry-copy padding of the reference's answer file
        (cloud.c:899-916) is applied lazily at the wire/file boundary
        (mp/wire.operand_to_bytes) — padding here costs a ~0.5 GB
        device concatenation per compute for nothing: both chaining
        and decryption take value[:, :width].
        """
        nbit = self.nbit_ks
        batch = result.shape[0]
        stream = prng.fresh_stream(
            0xA27, op, width, int(answer_codes.sum()) & 0x7FFFFFFF
        )
        neg_word = jnp.asarray(
            encrypt.encrypt_bits(
                nbit,
                words.values_to_bits(answer_codes.tolist(), META_WIDTH),
                prng.derive(stream, 0),
            )
        )
        bit_word = jnp.asarray(
            encrypt.encrypt_bits(
                nbit,
                words.values_to_bits([out_width] * batch, META_WIDTH),
                prng.derive(stream, 1),
            )
        )
        answer = Operand(neg_word, bit_word, result, carry_word)
        info = {
            "op": op,
            "width": width,
            "out_width": out_width,
            "neg_codes": sorted(set(answer_codes.tolist())),
            "combined_neg": sorted(set(combined.tolist())),
        }
        return answer, info

    def compute_chain(self, ops: list, operands: list):
        """A left-fold expression ``(((o0 op0 o1) op1 o2) ...)`` as
        ONE jitted dispatch (thin wrapper over :meth:`compute_steps`)."""
        if len(operands) != len(ops) + 1:
            raise ValueError("chain needs len(ops)+1 operands")
        steps = [(ops[0], ("opnd", 0), ("opnd", 1))]
        for k in range(1, len(ops)):
            steps.append((ops[k], ("step", k - 1), ("opnd", k + 1)))
        return self.compute_steps(steps, operands)

    def compute_steps(self, steps: list, operands: list):
        """A whole expression DAG as ONE jitted dispatch.

        steps: [(op, lhs, rhs)] where lhs/rhs reference an input
        operand ("opnd", i) or an earlier step ("step", j<k) — the
        output of scheduler.plan_postfix for any valid postfix
        (left folds like AB+C- and mul-first trees like ABC*-).

        Observably equivalent to sequential :meth:`compute` calls
        (pinned by tests/test_evaluator.py) minus the per-step
        metadata decrypt/encrypt round trips and dispatch latency —
        the "expression compiler" the SURVEY maps the reference's
        postfix walk onto (`dragonfly_cipher_cloud.py:682-731` +
        `compute_final` chaining → a compiled circuit graph).  The
        whole per-lane sign dataflow is planned host-side up front:
        every step's answer code is a pure function of the operands'
        cleartext negativity metadata.
        """
        from ieache.circuits import fused as fz

        plan, comps, sexts, answer_codes, combined, step_w = \
            self._plan_steps(steps, operands)
        amode = ("kogge" if self.adder == "kogge_stone"
                 else fz.adder_mode())
        result = _chain_exec(
            self.dck,
            tuple(o.value for o in operands),
            tuple(comps), tuple(sexts), tuple(plan),
            amode, fz.mul_mode(),
        )
        final_op = steps[-1][0]
        return self._finish_answer(
            final_op, max(plan[-1][1], plan[-1][2]), step_w[-1],
            answer_codes, combined, result, operands[0].carry_word,
        )

    def _plan_steps(self, steps: list, operands: list,
                    count_gates: bool = True):
        """Host-side chain planning shared by :meth:`compute_steps`
        and :meth:`chain_memory_analysis` — decrypts the cleartext
        metadata, resolves per-step widths/sign dataflows, and builds
        the static plan for :func:`_chain_exec`."""
        from ieache.circuits import fused as fz

        nbit = self.nbit_ks
        negs = [_decrypt_meta_value(nbit, o.neg_word) for o in operands]
        bitws = [
            int(_decrypt_meta_value(nbit, o.bit_word).max())
            for o in operands
        ]
        batch = operands[0].batch
        pb = fz.ADDER_BOOTSTRAPS_PER_BIT[fz.adder_mode()]
        use_kogge = self.adder == "kogge_stone"

        # Side descriptors (r5 chained-sign redesign): operands and
        # MUL results are ("coded", code_vec) — a magnitude plus the
        # reference's negativity code; ADD/SUB intermediates are
        # ("twos", negflag_vec, pure_vec) — raw two's-complement bits
        # whose lane value is (-1)^negflag * signed(bits), with `pure`
        # marking lanes whose bits are a provable magnitude sum (no
        # complement ever applied).  The previous scheme predicted a
        # sign CODE for every intermediate, but the sign of e.g.
        # (pos - pos) depends on the VALUES the evaluator cannot see —
        # downstream dataflow then misread the two's-complement bits
        # as a magnitude (the reference shares this flaw: its chained
        # answers re-import predicted codes, `cloud.c:798-827`, and
        # verif patches display-time sign heuristically,
        # `verif.c:132-166`).  Two's-complement intermediates carry no
        # sign claim at all, so every lane is exact; the per-lane
        # negflag folds into the NEXT step's complement flag (keeping
        # the cleartext carry <= 1 per add) and into the final answer
        # code (4/5 = negated magnitude / negated two's complement).
        step_kind, step_w = [], []

        def side_of(ref):
            if ref[0] == "opnd":
                return ("coded", negs[ref[1]], None)
            return step_kind[ref[1]]

        def w_of(ref):
            return (bitws[ref[1]] if ref[0] == "opnd"
                    else step_w[ref[1]])

        zeros = np.zeros(batch, np.int64)
        plan, comps, sexts = [], [], []
        answer_codes = combined = None
        for op, lhs, rhs in steps:
            if op == 3:  # 3 and 4 both mean multiply (see compute())
                op = OP_MUL
            wl, wr = w_of(lhs), w_of(rhs)
            w = max(wl, wr)
            ow = w
            if op == OP_MUL:
                kl = side_of(lhs)
                kr = side_of(rhs)

                def _mul_code(side):
                    # the schoolbook multiplier consumes magnitudes; a
                    # two's-complement intermediate is taken at its
                    # negflag sign (exact when the lane's running sign
                    # is tracked — magnitude-mode lanes; lanes whose
                    # true sign depends on the values stay heuristic,
                    # matching the reference's chained-answer re-import
                    # of predicted codes, cloud.c:798-827)
                    if side[0] == "coded":
                        return _normalized_neg(side[1])
                    return side[1].astype(np.int64)

                n1 = _mul_code(kl)
                n2 = _mul_code(kr)
                combined = n1 + 2 * n2
                answer_codes = np.array([0, 1, 2, 4])[combined]
                if w >= 256:
                    raise MulWidthError("Cannot multiply 256 bit number!")
                ow = 2 * w
                if count_gates:
                    if (fz.mul_mode() == "csa" and use_kogge
                            and batch * (w + 1) <= 64):
                        # latency mode, wave-bound regime: Wallace
                        self.gate_count += fz._wallace_bootstraps(
                            w, min(wl, wr)) * batch
                    elif fz.mul_mode() == "csa" and use_kogge:
                        # latency mode: windowed scan + prefix final
                        mn = min(wl, wr)
                        self.gate_count += (
                            w * mn + 2 * mn * (w + 1) + _kogge_count(w)
                        ) * batch
                    elif fz.mul_mode() == "csa":
                        self.gate_count += fz._csa_bootstraps_xy(
                            w, min(wl, wr), pb) * batch
                    else:
                        self.gate_count += (
                            fz.MUL_BOOTSTRAPS[fz.mul_mode()](w, pb)
                            * batch
                        )
                comp = zeros.astype(bool)
                sext = zeros          # mul outputs are magnitudes
                kinds = ("coded", "coded")
                step_kind.append(("coded", answer_codes, None))
            elif op in (OP_ADD, OP_SUB):
                kl = side_of(lhs)
                kr = side_of(rhs)
                opneg = 1 if op == OP_SUB else 0
                # lhs term: coded magnitude (el = its sign) or twos
                # bits (never complemented; negflag folds forward)
                if kl[0] == "coded":
                    el = _normalized_neg(kl[1])
                    fl = zeros
                    pl = np.ones(batch, np.int64)
                else:
                    el = zeros
                    fl = kl[1]
                    pl = kl[2]
                # rhs effective sign: code (or rhs negflag), the op,
                # and the lhs negflag all fold in; complementing works
                # for magnitudes and twos bits alike (~y + 1 == -y)
                er0 = (_normalized_neg(kr[1]) if kr[0] == "coded"
                       else kr[1])
                pr = (np.ones(batch, np.int64) if kr[0] == "coded"
                      else kr[2])
                er = er0 ^ opneg ^ fl
                # lanes whose lhs term is itself negative: negate the
                # whole lane instead (keeps the lhs uncomplemented and
                # the cleartext carry at <= 1)
                negf = (fl ^ el).astype(np.int64)
                er = er ^ el
                comp = er.astype(bool)
                pure = (pl & pr & (1 - er)).astype(np.int64)
                sext = 1 - pure       # impure lanes: bits are signed
                if count_gates:
                    if use_kogge:
                        self.gate_count += _kogge_count(w) * batch
                    else:
                        self.gate_count += pb * w * batch
                step_kind.append(("twos", negf, pure))
                # final answer code per lane (decrypt_answer tables):
                #   f=0 pure   -> plain     (ADD: 0, SUB: 2)
                #   f=0 impure -> signed    (ADD: 1, SUB: 0)
                #   f=1 pure   -> -plain    (ADD: 4, SUB: 1)
                #   f=1 impure -> -signed   (code 5, both)
                if op == OP_ADD:
                    tbl = np.array([0, 1, 4, 5])
                else:
                    tbl = np.array([2, 0, 1, 5])
                sel = 2 * negf + (1 - pure)
                answer_codes = tbl[sel]
                combined = el + 2 * er0  # effective signs (info only)
                kinds = (kl[0], kr[0])
            else:
                raise ValueError(f"bad op {op}")
            plan.append((op, wl, wr, ow, lhs, rhs, kinds))
            comps.append(jnp.asarray(comp))
            sexts.append(jnp.asarray(sext))
            step_w.append(ow)
        if count_gates and use_kogge and _csa3_fusable(tuple(plan)):
            # the fused 3-term path replaces the two chained prefix
            # adds with 3w compression bootstraps + ONE prefix add
            w = plan[1][3]
            self.gate_count += (3 * w - _kogge_count(w)) * batch
        return plan, comps, sexts, answer_codes, combined, step_w

    def chain_memory_analysis(self, steps: list, operands: list):
        """AOT-compile the whole-chain program (NO execution) and
        return XLA's device-memory accounting — the audit for shapes
        too large to run.  Returns a dict of byte sizes."""
        from ieache.circuits import fused as fz

        plan, comps, sexts, _codes, _comb, _w = self._plan_steps(
            steps, operands, count_gates=False
        )
        amode = ("kogge" if self.adder == "kogge_stone"
                 else fz.adder_mode())
        lowered = _chain_exec.lower(
            self.dck,
            tuple(o.value for o in operands),
            tuple(comps), tuple(sexts), tuple(plan),
            amode, fz.mul_mode(),
        )
        compiled = lowered.compile()
        ma = compiled.memory_analysis()
        out = {}
        for field in ("temp_size_in_bytes", "argument_size_in_bytes",
                      "output_size_in_bytes", "alias_size_in_bytes",
                      "generated_code_size_in_bytes"):
            out[field] = int(getattr(ma, field, -1))
        out["peak_bytes_estimate"] = (
            out["temp_size_in_bytes"] + out["argument_size_in_bytes"]
            + out["output_size_in_bytes"]
        )
        return out


def decrypt_answer(
    main_ks: SecretKeySet, nbit_ks: SecretKeySet, answer: Operand, op: int
) -> list:
    """Output-side decryption (verif semantics, C11;
    ``/root/reference/Output/verif.c:19-1653``).

    Interpretation table per (op, answer negativity code):
      add : 0 -> +mag ; 1,2 -> two's complement ; 4 -> -mag
      sub : 0,4 -> two's complement ; 1 -> -mag ; 2 -> +mag
      mul : 0,4 -> +mag ; 1,2 -> -mag
    (`verif.c:132-173,1424-1429` sign fix-up rules.)  Code 5 is a
    framework extension beyond the reference's vocabulary: NEGATED
    two's complement, emitted by the r5 chained-sign redesign for
    lanes whose whole-lane negation folded into the final code (the
    reference never emits it; its verif would need the same rule).
    """
    if op == 3:  # 3 and 4 both mean multiply (see CloudEvaluator.compute)
        op = OP_MUL
    codes = _decrypt_meta_value(nbit_ks, answer.neg_word)
    widths = _decrypt_meta_value(nbit_ks, answer.bit_word)
    width = int(widths.max())
    vals = words.decrypt_word(main_ks, answer.value[:, :width, :])

    def signed(v, w):
        return v - (1 << w) if v >= (1 << (w - 1)) else v

    def plain(v, w):
        return v

    def neg(v, w):
        return -v

    def neg_signed(v, w):
        return -signed(v, w)

    if op == OP_ADD:
        table = {0: plain, 1: signed, 2: signed, 4: neg, 5: neg_signed}
    elif op == OP_SUB:
        table = {0: signed, 4: signed, 1: neg, 2: plain, 5: neg_signed}
    elif op == OP_MUL:
        table = {0: plain, 4: plain, 1: neg, 2: neg}
    else:
        raise ValueError(f"bad op {op}")
    # sign fix-up applied per lane: a batch may mix negativity codes
    return [
        table[int(code)](v, int(w))
        for v, code, w in zip(vals, codes, widths)
    ]
