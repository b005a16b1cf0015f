"""Runtime services: the device route of each stage, chosen by platform,
and the persistent compilation cache.

Routes are fixed per JAX platform, decided once when an encoder context
or a decoder is built; nothing falls back to another route at call time:

* ``gpu``: the encode runs the plain-XLA formulation; the Huffman decode
  runs the Pallas kernel (Triton route, ``ops/huffman_kernel.py``).
* ``cpu``: every stage runs the plain-XLA formulation (the test suite).

Any other platform is an error.

The reference's first-iteration cost is ~233 ms (lazy buffer
allocation, FAQ.md:14-19); here the analogous cost is XLA compilation of
the per-geometry executables. The library therefore enables JAX's
persistent compilation cache at import, so a cold process re-encoding a
previously seen geometry pays a cache lookup instead of a compile.
``JAX_COMPILATION_CACHE_DIR`` chooses the directory; without it the
cache lives in ``.jax_cache`` at the root of the checkout.
``GPUJPEG_NO_COMPILE_CACHE=1`` disables the default entirely.
"""
from __future__ import annotations

import logging
import os
import stat

log = logging.getLogger(__name__)

#: root of the checkout the package runs from
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: compilation cache used when JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

#: device route of each stage, per JAX platform
ROUTES = {
    "gpu": {"encode": "xla", "huffman_decode": "kernel"},
    "cpu": {"encode": "xla", "huffman_decode": "xla"},
}


def device_routes(platform: str | None = None) -> dict:
    """Stage routes for ``platform`` (default: the first JAX device's)."""
    if platform is None:
        import jax
        platform = jax.devices()[0].platform
    try:
        return ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"no device route for JAX platform {platform!r}; "
            f"supported platforms: {', '.join(ROUTES)}") from None


def verify_private_dir(path: str) -> bool:
    """True when `path` is owned by us and not writable by others —
    guard before loading executable artifacts (.so) from it."""
    try:
        st = os.stat(path)
    except OSError:
        return False
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        return False
    return not (st.st_mode & (stat.S_IWGRP | stat.S_IWOTH))


_CACHE_WIRED = False


def enable_compilation_cache() -> None:
    """Idempotently point JAX's persistent compilation cache at
    :data:`DEFAULT_CACHE_DIR`, unless ``JAX_COMPILATION_CACHE_DIR`` or the
    caller already chose a directory."""
    global _CACHE_WIRED
    if _CACHE_WIRED or os.environ.get("GPUJPEG_NO_COMPILE_CACHE"):
        return
    _CACHE_WIRED = True
    try:
        import jax
        if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                or jax.config.jax_compilation_cache_dir):
            return  # the environment or the caller chose the cache
        os.makedirs(DEFAULT_CACHE_DIR, mode=0o700, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
        # the default thresholds (1 s / small-entry skip) would drop the
        # small staged jits that still cost hundreds of ms each
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except Exception as e:  # pragma: no cover - best effort
        log.debug("compilation cache setup skipped: %s", e)
