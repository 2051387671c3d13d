from ieache.lwe.types import (  # noqa: F401
    LweKey,
    TrlweKey,
    SecretKeySet,
    CloudKeySet,
    GateKeyPair,
)
from ieache.lwe import keygen, encrypt  # noqa: F401
