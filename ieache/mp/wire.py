"""Wire serialization of operands/answers (cloud.data / answer.data).

The reference's ``cloud.data`` is 11 words x 32 exported tfhe
ciphertexts per operand (neg, bitcount, 8 value limbs, carry —
``Client1/alice.c:166-191``), with metadata words under the nbit
keyset and value words under the main keyset; ``answer.data`` shares
the layout (``Cloud/cloud.c:899-916``) so intermediate answers chain
as operands.  We keep exactly that structure in an IEK1 container with
two arrays (one per keyset dimension).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ieache.circuits.evaluator import Operand
from ieache.codec import files
from ieache.params import TFHEParams


def operand_to_bytes(op: Operand, main_params: TFHEParams,
                     nbit_params: TFHEParams) -> bytes:
    nbit_words = np.concatenate(
        [np.asarray(op.neg_word), np.asarray(op.bit_word)], axis=1
    )  # (B, 64, n_nbit+1)
    value = np.asarray(op.value)
    carry = np.asarray(op.carry_word)
    slots = 8 * 32
    if value.shape[1] < slots:
        # the reference pads the answer file to 8 value slots with
        # copies of the carry word (cloud.c:899-916) — applied here,
        # at the wire boundary (in memory answers carry out_width bits)
        pads = -(-(slots - value.shape[1]) // 32)
        value = np.concatenate([value] + [carry] * pads, axis=1)
        value = value[:, :slots]
    main_words = np.concatenate(
        [value, carry], axis=1
    )  # (B, 288, n_main+1)
    return files.dumps_container(
        main_params,
        {"nbit_words": nbit_words, "main_words": main_words},
        kind="operand",
        extra={"nbit_params": nbit_params.name},
    )


def operand_from_bytes(blob: bytes) -> Operand:
    _, arrays, _ = files.loads_container(blob, "operand")
    nb = jnp.asarray(arrays["nbit_words"].astype(np.int32))
    mw = jnp.asarray(arrays["main_words"].astype(np.int32))
    return Operand(
        neg_word=nb[:, :32],
        bit_word=nb[:, 32:64],
        value=mw[:, :256],
        carry_word=mw[:, 256:288],
    )
