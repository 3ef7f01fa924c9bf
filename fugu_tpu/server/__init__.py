"""HTTP server package.  The aiohttp app loads on first use, so the
serving batcher (server/batcher.py) imports with JAX and numpy alone."""

__all__ = ["create_app", "start_http_server"]


def __getattr__(name):
    if name in __all__:
        from fugu_tpu.server import app

        return getattr(app, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
