"""Expression scheduler: postfix walk + operand pulls + chaining.

Counterpart of the reference Cloud orchestrator's dispatch
(``/root/reference/Cloud/dragonfly_cipher_cloud.py:645-731``): decode
the job descriptor, walk the postfix expression, pull each operand's
ciphertext stream from its client, evaluate, and chain intermediate
answers into the next operation.  The reference tracks operand order
with a ``flip`` flag (`:676-677,722-725,1306-1315`) because its
compute binary reads operands positionally from one file; the stack
walk below is order-correct by construction and needs no flag.

Guards replicated:
* jobs cap at 3 operands / 2 operators — the BER schema limit
  (`Cloud/declaration.asn:8-18`, SURVEY Appendix A);
* undersized answers (metadata-only) abort the run
  (`dragonfly_cipher_cloud.py:1295-1297`);
* 256-bit multiplication rejection bubbles up from the evaluator
  (exit-126, `cloud.c:860-864`).
"""

from __future__ import annotations

from ieache.circuits import evaluator as ev

#: CLI opcode map (`output_dynamic.py:1115-1124`): note '/' maps to
#: multiply — division is unimplemented in the reference (SURVEY A).
OPCODES = {"+": ev.OP_ADD, "-": ev.OP_SUB, "*": ev.OP_MUL, "/": ev.OP_MUL}

MAX_OPERANDS = 3
MAX_OPERATORS = 2


class JobError(Exception):
    pass


def parse_postfix(postfix: str):
    """-> (operand_letters_in_order, op_chars_in_order); validates caps."""
    operands = []
    ops = []
    for ch in postfix:
        if ch.isalpha():
            if ch not in operands:
                operands.append(ch)
        elif ch in OPCODES:
            ops.append(ch)
        else:
            raise JobError(f"bad token {ch!r} in postfix {postfix!r}")
    if len(operands) > MAX_OPERANDS:
        raise JobError(
            f"{len(operands)} operands exceed the wire limit of "
            f"{MAX_OPERANDS} (Cloud/declaration.asn:8-18)"
        )
    if len(ops) > MAX_OPERATORS:
        raise JobError(f"{len(ops)} operators exceed {MAX_OPERATORS}")
    return operands, ops


def plan_postfix(postfix: str):
    """Compile a postfix expression to an evaluation plan.

    Returns (letters_in_order, op_chars_in_order, steps) where steps
    is [(op_char, lhs, rhs)] with refs ("opnd", letter_index) /
    ("step", step_index) — the input of
    `CloudEvaluator.compute_steps`, which runs the WHOLE expression as
    one compiled circuit (left folds like AB+C- and mul-first trees
    like ABC*- alike).  Raises JobError on malformed postfix or wire
    caps, like walk_postfix.
    """
    parse_postfix(postfix)  # validate caps
    letters, steps, stack = [], [], []
    for ch in postfix:
        if ch.isalpha():
            if ch not in letters:
                letters.append(ch)
            stack.append(("opnd", letters.index(ch)))
        elif ch in OPCODES:
            if len(stack) < 2:
                raise JobError(f"malformed postfix {postfix!r}")
            rhs = stack.pop()
            lhs = stack.pop()
            steps.append((ch, lhs, rhs))
            stack.append(("step", len(steps) - 1))
        else:
            raise JobError(f"bad token {ch!r}")
    if len(stack) != 1 or stack[0][0] != "step":
        raise JobError(f"malformed postfix {postfix!r}")
    return letters, [s[0] for s in steps], steps


def walk_postfix(postfix: str, fetch_operand, compute):
    """Evaluate a postfix expression over encrypted operands.

    fetch_operand(letter) -> Operand (pulls the client's ciphertext
    stream, the reference's cipher()/cipher_ab() pulls,
    `dragonfly_cipher_cloud.py:755-1218`).
    compute(op_char, a, b) -> answer Operand (one ./cloud run,
    `:1219-1297`).

    Returns (final answer Operand, op_char of the final operator).
    """
    parse_postfix(postfix)  # validate caps
    stack = []
    last_op = None
    for ch in postfix:
        if ch.isalpha():
            stack.append(("ref", ch))
        elif ch in OPCODES:
            if len(stack) < 2:
                raise JobError(f"malformed postfix {postfix!r}")
            b_tok = stack.pop()
            a_tok = stack.pop()
            a = fetch_operand(a_tok[1]) if a_tok[0] == "ref" else a_tok[1]
            b = fetch_operand(b_tok[1]) if b_tok[0] == "ref" else b_tok[1]
            ans = compute(ch, a, b)
            stack.append(("val", ans))
            last_op = ch
        else:
            raise JobError(f"bad token {ch!r}")
    if len(stack) != 1 or stack[0][0] != "val":
        raise JobError(f"malformed postfix {postfix!r}")
    return stack[0][1], last_op
