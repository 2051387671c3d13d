from ieache.codec import files  # noqa: F401
