"""ieache — a TFHE gate-bootstrapping framework for the GPU.

A from-scratch rebuild of the capabilities of kennethsoh/IE-ACHE
(homomorphic evaluation of 2-3 operand integer expressions over TFHE
gate bootstrapping, with a multi-party Keygen/Client/Cloud/Output
protocol), re-designed around batched int8 matmuls on an accelerator:

* the TFHE primitive layer (the external C library the reference links
  as ``-ltfhe-spqlios-fma``; interface used at
  ``/root/reference/Cloud/cloud.c:24-46``) is re-implemented natively
  on top of JAX/XLA with the hot path expressed as int8 matmuls
  (see :mod:`ieache.core.poly` and :mod:`ieache.ops`);
* the homomorphic circuit library (``Cloud/cloud.c:18-647``) becomes
  batched circuits over a leading expression axis
  (:mod:`ieache.circuits`);
* the multi-party transport/key plane (Dragonfly SAE + AES key wrap +
  ASN.1 BER messaging) lives in :mod:`ieache.mp` and
  :mod:`ieache.codec`;
* multi-card scaling via ``jax.sharding`` meshes in
  :mod:`ieache.dist`.
"""

__version__ = "0.1.0"

from ieache.params import (  # noqa: F401
    TFHEParams,
    IEACHE_110,
    IEACHE_110_TFHE_COMPAT,
    TEST_TINY,
)
