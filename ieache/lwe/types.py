"""Key and ciphertext containers.

Mirrors the information content of tfhe-lib's keyset objects as used by
the reference (``TFheGateBootstrappingSecretKeySet`` /
``TFheGateBootstrappingCloudKeySet``, consumed at
``/root/reference/Keygen/keygen.c:29-51`` and
``/root/reference/Cloud/cloud.c:656-663``), re-shaped for array
programming:

* every ciphertext is a row of an int32 array with the body (``b``)
  in the **last** column — a batch of LWE ciphertexts is ``(B, n+1)``;
* a TRLWE sample is ``(k+1, N)`` with the body polynomial last;
* a TRGSW sample is ``((k+1) * l, k+1, N)`` where row ``p = u * l + j``
  carries gadget constant ``h_j = 2^(32 - (j+1) bg_bit)`` on
  component ``u``;
* the bootstrapping key stacks n TRGSW samples; the keyswitch key is a
  flat LWE matrix ``(kN * t, n+1)`` whose row ``i * t + j`` encrypts
  ``s_ext[i] * 2^(32 - (j+1) ks_basebit)`` (the *linear* keyswitch
  variant: output = b-unit minus digit-matrix @ KS, which is one int8
  int8 matmul on device — see ieache/ops/keyswitch.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ieache.params import TFHEParams


@dataclasses.dataclass
class LweKey:
    params: TFHEParams
    s: np.ndarray  # int32[n], binary


@dataclasses.dataclass
class TrlweKey:
    params: TFHEParams
    coefs: np.ndarray  # int32[k, N], binary

    @property
    def extracted(self) -> np.ndarray:
        """Key of a sample-extracted LWE ciphertext: K flattened (kN,)."""
        return self.coefs.reshape(-1)


@dataclasses.dataclass
class CloudKeySet:
    """Evaluation keys (the reference's ``cloud.key``)."""

    params: TFHEParams
    bk: np.ndarray  # int32[n, (k+1) l, k+1, N]
    ks: np.ndarray  # int32[kN * t, n+1]


@dataclasses.dataclass
class SecretKeySet:
    """Secret keys + the evaluation keys (reference ``secret.key``)."""

    params: TFHEParams
    lwe_key: LweKey
    trlwe_key: TrlweKey
    cloud: CloudKeySet


@dataclasses.dataclass
class GateKeyPair:
    """The reference's dual keysets: 'main' (values) + 'nbit' (metadata).

    ``Keygen/keygen.c:30-36`` generates two independent keysets from
    seeds {314,1592,657} and {314,1592,888}; value limbs are encrypted
    under `main`, negativity/bit-count words under `nbit`
    (``Client1/alice.c:116-125``).
    """

    main: SecretKeySet
    nbit: SecretKeySet
