"""Environment introspection and process set-up (ref:
detectron/lib/utils/env.py)."""

from __future__ import annotations

import functools
import importlib
import os
from types import ModuleType
from typing import Dict, Optional

# The checkout this package runs from (sad_tpu/utils/env.py -> repo root).
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_COMPILE_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def get_runtime_info() -> Dict[str, str]:
    import jax

    info = {
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "device_count": str(jax.device_count()),
        "devices": ", ".join(str(d) for d in jax.devices()),
    }
    try:
        import flax

        info["flax_version"] = flax.__version__
    except ImportError:
        pass
    return info


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    JAX itself reads ``JAX_COMPILATION_CACHE_DIR``; when it is set, that
    directory is used and nothing is set here. Otherwise the cache lives at
    one fixed path inside the checkout (``.jax_cache``, git-ignored): the
    directory is part of the cache key, so it must not move between runs.
    Call before the first compilation."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    return DEFAULT_COMPILE_CACHE_DIR


@functools.lru_cache(maxsize=None)
def optional_module(name: str) -> Optional[ModuleType]:
    """`name` imported, or None when it is not installed (for optional fast
    paths such as cv2, which have numpy fallbacks)."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def get_native_kernels_lib() -> str:
    """Path of the compiled host-kernels library (the dyndep analogue of
    lib/utils/env.py get_detectron_ops_lib)."""
    from sad_tpu import native

    lib = native._get_lib()
    return native._SO if lib is not None else "(numpy fallback)"
