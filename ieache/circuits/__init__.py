from ieache.circuits import arith, words  # noqa: F401
