from ieache.ops import decompose, blind_rotate, keyswitch  # noqa: F401
