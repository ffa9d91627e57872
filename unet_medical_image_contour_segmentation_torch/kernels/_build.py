"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``<build dir>/<name>-<hash>.so`` on first use; the
hash covers the source and the flags, so an edited source builds anew.  The
build directory is resolved at each build, never at import, by
``utils/compile_cache.py:kernel_build_dir``: ``build/torch_kernels/`` of a
source checkout, ``$UMICS_COMPILE_CACHE_DIR/torch_kernels`` when that is
set, else ``~/.cache/umics/torch_kernels`` (an installed package).  The
build is never skipped: a kernel whose library fails to build raises, and
no plain version runs in its place.  Nothing here runs at import time: the
CPU tests import every module, and this machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

from ..utils.compile_cache import kernel_build_dir
from ..utils.profiling import span

__all__ = ["BuildResult", "build", "load_library", "CSRC_DIR"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600


@dataclass(frozen=True)
class BuildResult:
    name: str
    library: Path
    log: str          # nvcc's stderr: the -Xptxas -v registers / smem / spills
    seconds: float    # 0.0 when the library was already built


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(build_dir: Path, name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir / f"{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, BuildResult]:
    """Compile every named source not yet built, one nvcc each, all at once,
    into the build directory (see the module docstring)."""
    build_dir = kernel_build_dir()
    build_dir.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = []
    for name in names:
        lib = _target(build_dir, name)
        log_path = lib.with_suffix(".log")
        if lib.exists():
            log = log_path.read_text() if log_path.exists() else ""
            results[name] = BuildResult(name, lib, log, 0.0)
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running.append((name, lib, tmp, log_path, proc, time.perf_counter()))
    failures = []
    for name, lib, tmp, log_path, proc, t0 in running:
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failures.append(f"{name}: nvcc timed out after {NVCC_TIMEOUT_S} s")
            continue
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        log_path.write_text(log)
        results[name] = BuildResult(name, lib, log, time.perf_counter() - t0)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it on first use
    (the span ``setup.kernels``; ``built``: nvcc ran)."""
    with _load_lock:
        if name not in _loaded:
            with span("setup.kernels", kernel=name) as s:
                result = build([name])[name]
                s["built"] = result.seconds > 0
                _loaded[name] = ctypes.CDLL(str(result.library))
        return _loaded[name]
