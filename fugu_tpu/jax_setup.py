"""One-time JAX runtime configuration for the engine.

Enables the persistent compilation cache: ``JAX_COMPILATION_CACHE_DIR``
when it is set (JAX reads it itself; nothing here overrides it), else
``.jax_cache`` at the root of the checkout — a fixed path, so the cache
hits across processes.  Opt out with FUGU_NO_COMPILE_CACHE=1.
"""

from __future__ import annotations

import os
from pathlib import Path

_configured = False


def fetch_np(arrays):
    """Device→host transfer of a flat list of arrays, overlapped:
    every D2H copy starts (``copy_to_host_async``) before the first
    read.  Returns numpy arrays."""
    import numpy as np

    for a in arrays:
        start = getattr(a, "copy_to_host_async", None)
        if start is not None:
            try:
                start()
            except Exception:  # non-addressable/committed arrays
                pass
    return [np.asarray(a) for a in arrays]


#: compile-cache directory when JAX_COMPILATION_CACHE_DIR is unset
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def pallas_interpret() -> bool:
    """Whether Pallas kernels run in interpret mode: only when
    ``FUGU_PALLAS_INTERPRET=1`` says so.  The CPU test suite sets it (a
    Triton kernel compiles only for a GPU); nothing chooses it by
    looking at the backend."""
    return os.environ.get("FUGU_PALLAS_INTERPRET") == "1"


def configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    if os.environ.get("FUGU_NO_COMPILE_CACHE"):
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        CACHE_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
