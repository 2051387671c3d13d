from ieache.core import poly  # noqa: F401
