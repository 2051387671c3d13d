from ieache.mp import dragonfly, keywrap  # noqa: F401
