"""Where the port's compiled kernels live (port of
``tpu_engine/compile_cache.py``).

JAX's persistent cache keys XLA executables so that a resumed job pays a
cache hit instead of a cold compile. The port's compile is the build of its
kernel library: ``nvcc`` over ``tpu_engine_torch/csrc`` into
``tpu_engine_torch.ops._flash_cuda.BUILD_DIR``, the library named by a hash
of the sources, headers and flags (``library_path``), so a directory that
already holds it is a hit and a resumed job on the same directory skips the
build. :func:`enable_compilation_cache` points that build directory at a
directory of the caller's (a persistent volume across restarts); the
default stays ``tpu_engine_torch/_build/``.

Enabled by every supervised job (``tpu_engine_torch/supervisor.py``);
idempotent. The fleet-level warm/cold bookkeeping lives in
``tpu_engine_torch/compile_index.py`` — enabling here attaches that index's
JSON sidecar to the directory.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

log = logging.getLogger(__name__)

# The build directory the kernel library module starts with.
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parent / "_build")

_enabled_dir: Optional[str] = None


@dataclass(frozen=True, eq=False)
class CacheEnableResult:
    """Structured outcome of :func:`enable_compilation_cache`.

    ``dir`` is the directory the cache is active with after this call (None
    when nothing is enabled); ``changed`` means this call moved the kernel
    build directory (first enable, or a re-point); ``repointed`` flags the
    explicit already-enabled → different-explicit-dir transition;
    ``skipped_reason`` names why the call was a no-op (only
    ``"no-cuda-device"``).

    Compares equal to the directory string (and to None when nothing is
    enabled) so existing ``enable_compilation_cache(d) == d`` call sites
    keep working; truthiness is "the cache is enabled".
    """

    dir: Optional[str]
    enabled: bool
    changed: bool = False
    repointed: bool = False
    skipped_reason: Optional[str] = None

    def __bool__(self) -> bool:
        return self.enabled

    def __eq__(self, other: object) -> bool:
        if isinstance(other, CacheEnableResult):
            return (self.dir, self.enabled, self.changed, self.repointed,
                    self.skipped_reason) == (
                        other.dir, other.enabled, other.changed,
                        other.repointed, other.skipped_reason)
        if other is None or isinstance(other, str):
            return self.dir == other
        return NotImplemented


def enable_compilation_cache(
    cache_dir: Optional[str] = None, force: bool = False
) -> CacheEnableResult:
    """Point the kernel build directory at ``cache_dir`` (idempotent).

    Without ``cache_dir``, the package's ``_build/``. Returns a
    :class:`CacheEnableResult`.

    Calling again with a *different* directory is an explicit **re-point**:
    later builds land in the new directory (a library already loaded in
    this process stays loaded), the transition is logged, and the result
    carries ``repointed=True``. Libraries already in the old directory are
    not migrated.

    NOT enabled without a CUDA device unless ``force``: nothing is built
    there (the CPU runs the kernels' plain versions), as JAX skips its CPU
    backend.
    """
    global _enabled_dir
    d = cache_dir or DEFAULT_CACHE_DIR
    if _enabled_dir == d:
        return CacheEnableResult(dir=d, enabled=True, changed=False)
    if not force and not torch.cuda.is_available():
        log.info("no CUDA device: kernel build directory not moved")
        return CacheEnableResult(
            dir=_enabled_dir,
            enabled=_enabled_dir is not None,
            skipped_reason="no-cuda-device",
        )

    from tpu_engine_torch.ops import _flash_cuda

    repointed = _enabled_dir is not None
    if repointed:
        log.warning(
            "kernel build directory re-pointed: %s -> %s "
            "(existing libraries are not migrated)",
            _enabled_dir, d,
        )
    os.makedirs(d, exist_ok=True)
    _flash_cuda.BUILD_DIR = Path(d)
    _enabled_dir = d
    log.info("kernel build directory: %s", d)
    # The fleet compile index persists its sidecar next to the libraries it
    # describes — warmth then survives the process.
    try:
        from tpu_engine_torch.compile_index import get_index

        get_index().attach_dir(d)
    except Exception:  # the index must never break cache enablement
        log.debug("compile index sidecar attach failed", exc_info=True)
    return CacheEnableResult(dir=d, enabled=True, changed=True, repointed=repointed)


def cache_dir_in_use() -> Optional[str]:
    """The directory the cache was enabled with, or None."""
    return _enabled_dir
