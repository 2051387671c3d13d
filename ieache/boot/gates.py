"""Batched homomorphic gate API.

Re-implements the tfhe-lib gate surface the reference consumes
(``bootsAND/XOR/NOT/COPY/CONSTANT`` at
``/root/reference/Cloud/cloud.c:30-63``, plus the rest of the standard
family) with a leading batch axis: the reference's OpenMP
``parallel sections`` over 2-4 independent gates
(``cloud.c:27-41,156-161,458-471``) becomes arbitrary-width batching —
all gates in a batch share one blind-rotation scan.

Every two-input gate is `bootstrap(alpha1*c1 + alpha2*c2 + (0, beta))`;
the table below is the tfhe-lib linear form for each gate.
`apply_gate_batch` evaluates a *mixed* batch (per-element opcode) at
the cost of a single bootstrap, which is what the circuit evaluator
uses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ieache.boot.bootstrap import (
    MU,
    DeviceCloudKey,
    bootstrap,
    bootstrap_no_ks,
)
from ieache.ops.keyswitch import keyswitch

#: gate -> (alpha1, alpha2, beta): bootstrap(a1*c1 + a2*c2 + (0, beta))
GATE_TABLE = {
    "AND":   (1, 1, -MU),
    "OR":    (1, 1, MU),
    "NAND":  (-1, -1, MU),
    "NOR":   (-1, -1, -MU),
    "XOR":   (2, 2, 2 * MU),
    "XNOR":  (-2, -2, -2 * MU),
    "ANDNY": (-1, 1, -MU),   # (not c1) and c2
    "ANDYN": (1, -1, -MU),   # c1 and (not c2)
    "ORNY":  (-1, 1, MU),    # (not c1) or c2
    "ORYN":  (1, -1, MU),    # c1 or (not c2)
}

#: stable opcode numbering for mixed batches
GATE_OPCODES = {name: i for i, name in enumerate(GATE_TABLE)}
_ALPHA1 = jnp.array([GATE_TABLE[g][0] for g in GATE_TABLE], jnp.int32)
_ALPHA2 = jnp.array([GATE_TABLE[g][1] for g in GATE_TABLE], jnp.int32)
_BETA = jnp.array([GATE_TABLE[g][2] for g in GATE_TABLE], jnp.int32)


def _linear_combo(c1, c2, a1, a2, beta, n):
    pre = a1[:, None] * c1 + a2[:, None] * c2
    return pre.at[:, n].add(beta)


def _gate(name: str, c1: jnp.ndarray, c2: jnp.ndarray,
          key: DeviceCloudKey) -> jnp.ndarray:
    a1, a2, beta = GATE_TABLE[name]
    n = key.params.n
    pre = jnp.int32(a1) * c1 + jnp.int32(a2) * c2
    pre = pre.at[:, n].add(jnp.int32(beta))
    return bootstrap(pre, key)


def AND(c1, c2, key):   return _gate("AND", c1, c2, key)    # noqa: E704
def OR(c1, c2, key):    return _gate("OR", c1, c2, key)     # noqa: E704
def NAND(c1, c2, key):  return _gate("NAND", c1, c2, key)   # noqa: E704
def NOR(c1, c2, key):   return _gate("NOR", c1, c2, key)    # noqa: E704
def XOR(c1, c2, key):   return _gate("XOR", c1, c2, key)    # noqa: E704
def XNOR(c1, c2, key):  return _gate("XNOR", c1, c2, key)   # noqa: E704
def ANDNY(c1, c2, key): return _gate("ANDNY", c1, c2, key)  # noqa: E704
def ANDYN(c1, c2, key): return _gate("ANDYN", c1, c2, key)  # noqa: E704
def ORNY(c1, c2, key):  return _gate("ORNY", c1, c2, key)   # noqa: E704
def ORYN(c1, c2, key):  return _gate("ORYN", c1, c2, key)   # noqa: E704


def NOT(c: jnp.ndarray) -> jnp.ndarray:
    """bootsNOT: negation, no bootstrap (`cloud.c:59-63` semantics)."""
    return -c


def COPY(c: jnp.ndarray) -> jnp.ndarray:
    """bootsCOPY: identity."""
    return c


def CONSTANT(bits: jnp.ndarray, n: int) -> jnp.ndarray:
    """bootsCONSTANT: trivial LWE(±1/8) batch (`cloud.c:53-57`)."""
    bits = jnp.asarray(bits)
    out = jnp.zeros(bits.shape + (n + 1,), jnp.int32)
    return out.at[..., n].set(
        jnp.where(bits != 0, jnp.int32(MU), jnp.int32(-MU))
    )


@jax.jit
def MUX(sel, c1, c2, key: DeviceCloudKey):
    """bootsMUX: sel ? c1 : c2 — two bootstraps + one keyswitch."""
    p = key.params
    n = p.n
    t1 = sel + c1
    t1 = t1.at[:, n].add(jnp.int32(-MU))
    u1 = bootstrap_no_ks(t1, key)           # sel AND c1 (extracted dim)
    t2 = -sel + c2
    t2 = t2.at[:, n].add(jnp.int32(-MU))
    u2 = bootstrap_no_ks(t2, key)           # (not sel) AND c2
    u = u1 + u2
    u = u.at[:, p.kN].add(jnp.int32(MU))
    return keyswitch(u, key.ks_limbs, p)


@jax.jit
def apply_gate_batch(opcodes: jnp.ndarray, c1: jnp.ndarray,
                     c2: jnp.ndarray, key: DeviceCloudKey) -> jnp.ndarray:
    """Mixed-gate batch: per-element opcode (see GATE_OPCODES).

    One bootstrap for the whole batch regardless of the gate mix.
    """
    n = key.params.n
    a1 = _ALPHA1[opcodes]
    a2 = _ALPHA2[opcodes]
    beta = _BETA[opcodes]
    pre = a1[:, None] * c1 + a2[:, None] * c2
    pre = pre.at[:, n].add(beta)
    return bootstrap(pre, key)
