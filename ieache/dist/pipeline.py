"""Device-level pipeline parallelism for expression chains.

The reference evaluates a chained expression by staging it across
hosts: Cloud pulls operands from one client after another and feeds
each intermediate ``answer.data`` back in as the next operand
(``/root/reference/Cloud/dragonfly_cipher_cloud.py:1300-1327``) — a
TCP/file-drop pipeline. The SURVEY §2 parallelism table maps this onto
Pipeline parallelism: *expression stages across devices, handoff
via collectives instead of files*. This module is that mapping.

A chain ``v0 (op0) v1 (op1) v2 ...`` with S ops is laid across a
one-axis ``pp`` mesh: stage ``s`` holds operand ``s+1`` (and its
add/sub flag) and applies ``flow <- flow ± operand`` with the fused
ripple adder; the flowing partial result hops stage→stage with one
``lax.ppermute`` per tick (the ICI replacing the reference's
``answer.data`` re-upload). The expression batch is split into
``n_micro`` microbatches, GPipe-style: after an S−1-tick fill, all S
stages bootstrap concurrently on different microbatches, so a chain's
serial op dependency no longer serializes the devices.

Semantics are two's-complement mod 2^W (subtract = add NOT(y) with
carry-in 1, `cloud.c:1225-1245`); the gate sequence per lane is
identical to running the fused adders back-to-back on one device, so
outputs are **bit-identical** to the unpipelined chain
(tests/test_pipeline.py asserts ciphertext equality).

Ticks are unrolled statically: the reference's wire schema caps a job
at 2 operators (`Cloud/declaration.asn:8-18`), so S and the tick count
stay small; microbatch count only adds S+M−1 adder programs, each
compiled once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from jax.sharding import Mesh, PartitionSpec as P

from ieache.boot import gates
from ieache.boot.bootstrap import DeviceCloudKey
from ieache.circuits import fused
from ieache.params import TFHEParams


def make_pp_mesh(n_stages: int, devices=None) -> Mesh:
    """One-axis (pp,) mesh over the first n_stages devices."""
    devices = list(devices or jax.devices())
    if n_stages > len(devices):
        raise ValueError(
            f"need {n_stages} devices for {n_stages} stages, "
            f"have {len(devices)}"
        )
    return Mesh(np.array(devices[:n_stages]), axis_names=("pp",))


def make_pipelined_chain(mesh: Mesh, params: TFHEParams, n_micro: int,
                         stage_ops=None):
    """Build the jitted pipelined chain evaluator.

    Returns ``fn(flow0, operands, comps, bk, ks_limbs) -> result``:

    * ``flow0``    (B, W, n+1) int32 — operand 0's encrypted word
      (replicated; B must divide by n_micro);
    * ``operands`` (S, B, W, n+1) int32 — operand s+1's word, sharded
      over ``pp`` (stage s only ever touches its own slice);
    * ``comps``    (S, B) int32 — per-stage per-lane flags: 0 means
      ``flow + operand``, nonzero means ``flow - operand``
      (two's-complement subtract riding the adder carry-in; ignored
      by ``*`` stages);
    * ``bk``/``ks_limbs`` — DeviceCloudKey fields, replicated.

    ``stage_ops`` assigns each stage its operator: a sequence of
    ``'+'`` (add/sub, per-lane via comps) or ``'*'`` (carry-save
    multiply, low-W product) per stage, default all ``'+'``.  This
    covers the reference's benchmarked chain shapes A+B*C / A-B*C
    (`AC058.pdf` Fig.7): postfix ``ABC*+`` is the chain
    ``B (*C) (+A)`` = ``stage_ops=('*', '+')``.  Width stays fixed at
    W; for reference mul width-doubling semantics run the chain at the
    final output width with zero-extended operands (the evaluator's
    width plan already computes it).  Mixed-op stages run under a
    per-device ``lax.switch`` — each stage executes only its own
    branch at runtime.

    Result (B, W, n+1) is the chain value mod 2^W, replicated (a psum
    collects it off the last stage).
    """
    n_stages = mesh.shape["pp"]
    if stage_ops is None:
        stage_ops = ("+",) * n_stages
    stage_ops = tuple(stage_ops)
    if len(stage_ops) != n_stages:
        raise ValueError(
            f"{len(stage_ops)} stage_ops for {n_stages} stages"
        )
    if any(o not in "+*" for o in stage_ops):
        raise ValueError(f"stage_ops must be '+'/'*', got {stage_ops}")
    op_codes = np.array(
        [0 if o == "+" else 1 for o in stage_ops], np.int32
    )
    has_mul = bool(op_codes.any())

    def fn(flow0, operands, comps, bk, ks_limbs):
        dck = DeviceCloudKey(bk=bk, ks_limbs=ks_limbs, params=params)
        n = params.n
        b, w, m1 = flow0.shape
        mb = b // n_micro
        s_idx = jax.lax.axis_index("pp")
        my_ops = operands[0]                      # (B, W, n+1)
        my_comp = comps[0]                        # (B,)
        my_code = jnp.asarray(op_codes)[s_idx]

        def addsub_stage(inp, y, comp):
            y = jnp.where((comp != 0)[:, None, None], gates.NOT(y), y)
            out, _ = fused.ripple_add(
                inp, y, gates.CONSTANT(comp, n), dck
            )
            return out

        def mul_stage(inp, y, comp):
            prod = fused.schoolbook_mul_csa(inp, y, dck)  # (mb, 2W, .)
            return prod[:, :w, :]                 # low-W product

        def stage_body(inp, y, comp):
            if not has_mul:
                return addsub_stage(inp, y, comp)
            return jax.lax.switch(
                my_code, [addsub_stage, mul_stage], inp, y, comp
            )

        zeros_mb = jnp.zeros((mb, w, m1), jnp.int32)
        cur = zeros_mb          # value arriving at this stage this tick
        outbuf = jnp.zeros((b, w, m1), jnp.int32)
        perm = [(i, i + 1) for i in range(n_stages - 1)]

        for t in range(n_stages + n_micro - 1):
            # stage 0 injects flow microbatch t (fill phase only)
            inp0 = (
                jax.lax.dynamic_slice(
                    flow0, (t * mb, 0, 0), (mb, w, m1)
                ) if t < n_micro else zeros_mb
            )
            inp = jnp.where(s_idx == 0, inp0, cur)

            # this stage's microbatch index this tick (clamped during
            # fill/drain bubbles — those outputs are never recorded)
            m = jnp.clip(t - s_idx, 0, n_micro - 1)
            start = m * mb
            y = jax.lax.dynamic_slice(
                my_ops, (start, 0, 0), (mb, w, m1)
            )
            comp = jax.lax.dynamic_slice(my_comp, (start,), (mb,))
            out = stage_body(inp, y, comp)

            # record on the last stage (its tick-t microbatch is
            # t-(S-1); only valid ones land in outbuf)
            ml = t - (n_stages - 1)
            if 0 <= ml < n_micro:
                rec = jnp.where(s_idx == n_stages - 1, out, 0)
                outbuf = jax.lax.dynamic_update_slice(
                    outbuf, rec, (ml * mb, 0, 0)
                )

            # hand the partial result to the next stage over the ICI
            if perm:
                cur = jax.lax.ppermute(out, "pp", perm)
            else:                                 # single stage
                cur = out

        return jax.lax.psum(outbuf, "pp")

    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(
            P(),                                  # flow0 replicated
            P("pp", None, None, None),            # stage operands
            P("pp", None),                        # stage comp flags
            P(), P(),                             # keys replicated
        ),
        out_specs=P(),
    )
    jitted = jax.jit(mapped)

    def call(flow0, operands, comps, bk, ks_limbs):
        # validate GLOBAL shapes here, outside shard_map — inside,
        # only the per-shard slice is visible, so a stage-count
        # mismatch that isn't a multiple of the pp size would surface
        # as an opaque sharding-divisibility error instead
        if operands.shape[0] != n_stages:
            raise ValueError(
                f"chain has {operands.shape[0]} stages but the pp "
                f"mesh axis has {n_stages} devices — they must match "
                "(one stage per device)"
            )
        if comps.shape[0] != n_stages:
            raise ValueError(
                f"comps has {comps.shape[0]} stages, expected "
                f"{n_stages}"
            )
        if flow0.shape[0] % n_micro:
            raise ValueError(
                f"batch {flow0.shape[0]} not divisible by "
                f"n_micro={n_micro}"
            )
        return jitted(flow0, operands, comps, bk, ks_limbs)

    return call


@functools.partial(jax.jit, static_argnames=("params", "stage_ops"))
def chain_unpipelined(flow0, operands, comps, bk, ks_limbs,
                      params: TFHEParams, stage_ops=None):
    """The same chain on one device (the bit-exactness reference)."""
    dck = DeviceCloudKey(bk=bk, ks_limbs=ks_limbs, params=params)
    n = params.n
    w = flow0.shape[1]
    if stage_ops is None:
        stage_ops = ("+",) * operands.shape[0]
    out = flow0
    for s in range(operands.shape[0]):
        y, comp = operands[s], comps[s]
        if stage_ops[s] == "*":
            out = fused.schoolbook_mul_csa(out, y, dck)[:, :w, :]
        else:
            y = jnp.where((comp != 0)[:, None, None], gates.NOT(y), y)
            out, _ = fused.ripple_add(
                out, y, gates.CONSTANT(comp, n), dck
            )
    return out
