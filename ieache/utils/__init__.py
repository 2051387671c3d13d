from ieache.utils import prng  # noqa: F401
