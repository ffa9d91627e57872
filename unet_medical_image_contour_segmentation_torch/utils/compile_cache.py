"""Where the port's CUDA kernels build: its counterpart of the JAX package's
persistent compilation cache (``utils/compile_cache.py`` there).

The JAX package caches XLA executables under ``UMICS_COMPILE_CACHE_DIR``
(default ``~/.cache/umics/xla_cache``).  The port compiles its kernels with
nvcc (``kernels/_build.py``), so its cache is the directory of built
libraries, named by a hash of source and flags.  :func:`kernel_build_dir`
picks it:

* ``$UMICS_COMPILE_CACHE_DIR/torch_kernels`` when that variable is set (the
  variable the JAX package reads, so one setting serves both);
* else ``build/torch_kernels/`` of the source checkout the package sits in:
  the directory above the package holds this repository's
  ``pyproject.toml`` and is writable;
* else ``~/.cache/umics/torch_kernels`` (an installed package: its parent is
  ``site-packages``, outside any checkout and often read-only).

``UMICS_COMPILE_CACHE=0`` turns the JAX cache off; the port does not read
it, since its kernels cannot run unbuilt: every launch needs the library.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["CACHE_DIR_ENV", "kernel_build_dir"]

CACHE_DIR_ENV = "UMICS_COMPILE_CACHE_DIR"
PACKAGE_DIR = Path(__file__).resolve().parent.parent
_PROJECT_LINE = 'name = "unet-medical-image-contour-segmentation-tpu"'


def _checkout_root(package_dir: Path) -> Optional[Path]:
    """The source checkout that holds ``package_dir``, if it is one and can
    be written to."""
    root = package_dir.parent
    try:
        pyproject = (root / "pyproject.toml").read_text()
    except OSError:
        return None
    if _PROJECT_LINE not in pyproject or not os.access(root, os.W_OK):
        return None
    return root


def kernel_build_dir(package_dir: Path = PACKAGE_DIR) -> Path:
    """The directory the kernels of the package at ``package_dir`` build
    into (see the module docstring); reads the environment and the file
    system on each call, and creates nothing."""
    if os.environ.get(CACHE_DIR_ENV):
        return Path(os.environ[CACHE_DIR_ENV]).expanduser() / "torch_kernels"
    root = _checkout_root(Path(package_dir))
    if root is not None:
        return root / "build" / "torch_kernels"
    return Path.home() / ".cache" / "umics" / "torch_kernels"
