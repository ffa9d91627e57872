"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``<build dir>/<name>-<hash>.so`` on first use; the
hash covers the source and the flags, so an edited source builds anew.  The
build directory is resolved at each build, never at import, by
``utils/compile_cache.py:kernel_build_dir``: ``build/torch_kernels/`` of a
source checkout, ``$UMICS_COMPILE_CACHE_DIR/torch_kernels`` when that is
set, else ``~/.cache/umics/torch_kernels`` (an installed package).  The
build is never skipped: a kernel whose library fails to build raises, and
no plain version runs in its place.  Nothing here builds at import time:
the CPU tests import every module, and this machine may have no nvcc.

Every hand kernel reaches PyTorch through one seam here.  A kernel module
declares its library once (:class:`KernelLibrary`: the C entries' ctypes
signatures, set when the library loads) and its operator once
(:func:`register_op`: ``umics::<name>`` defined on one held
``Library("umics", "FRAGMENT")`` with ``define`` / ``impl``, its CUDA
implementation the kernel's launch, its CPU implementation the plain
version, its fake implementation the output's shape and dtype; neither
registration nor dispatch imports ``torch._dynamo``).  Every launch goes
through :func:`launch`, which counts it in :data:`LAUNCHES`, and every C
entry is called by :meth:`KernelLibrary.launch`: on the operand's device
and the current raw stream there, passed as its last two arguments ``(int
device, void* stream)`` (the C side sets and restores the device), a
nonzero return raised with the library's own error string.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..utils.compile_cache import kernel_build_dir
from ..utils.profiling import span

__all__ = ["BuildResult", "build", "load_library", "CSRC_DIR", "LAUNCHES", "KernelLibrary",
           "launch", "register_launch", "register_op"]

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


class KernelLibrary:
    """``csrc/<source>.cu``'s library: built and loaded on first use, when
    each C entry named in ``signatures`` (name -> (argtypes, restype)) gets
    its ctypes signature, and ``<source>_error_string`` too."""

    def __init__(self, source: str, **signatures: Tuple[list, type]):
        self.source = source
        self._signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None

    def _load(self) -> ctypes.CDLL:
        lib = load_library(self.source)
        for name, (argtypes, restype) in self._signatures.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        fn = getattr(lib, f"{self.source}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        self._lib = lib
        return lib

    def entry(self, name: str):
        """The C entry ``name``, its signature set."""
        return getattr(self._lib or self._load(), name)

    def check(self, err: int, what: str) -> None:
        """Raise for a nonzero ``err`` of ``what``, with the library's string for it."""
        if err:
            text = self.entry(f"{self.source}_error_string")(err).decode()
            raise RuntimeError(f"{what} failed: {text} ({err})")

    def launch(self, entry: str, t: torch.Tensor, *args) -> None:
        """``entry(*args, device, stream)`` on CUDA tensor ``t``'s device and
        the current raw stream there; a nonzero return raises."""
        device = t.get_device()
        err = getattr(self._lib or self._load(), entry)(
            *args, device, torch._C._cuda_getCurrentRawStream(device))
        if err:
            self.check(err, f"{entry} of {tuple(t.shape)}")


LAUNCHES: Counter = Counter()  # launches by op, and by "<op>.<route>" for a routed kernel
_RUNS: Dict[str, Tuple[Callable, Optional[Callable]]] = {}
_UMICS = torch.library.Library("umics", "FRAGMENT")  # held: the registrations live with it


def launch(op: str, *operands) -> torch.Tensor:
    """The one launch path of every hand kernel: ``op``'s launch on its
    operands as the op received them (trailing defaults may be left out),
    counted in :data:`LAUNCHES` under ``op`` and, where the kernel has a
    route, under ``"<op>.<route>"`` too."""
    run, route = _RUNS[op]
    out = run(*operands)
    LAUNCHES[op] += 1
    if route is not None:
        LAUNCHES[f"{op}.{route(*operands)}"] += 1
    return out


def register_launch(op: str, run: Callable, route: Optional[Callable] = None) -> None:
    """Make ``run`` (CUDA operands -> output) the launch of ``op`` in
    :func:`launch`; ``route`` (the same operands -> a name) splits its count."""
    _RUNS[op] = (run, route)


def register_op(schema: str, run: Callable, cpu: Callable, fake: Callable,
                route: Optional[Callable] = None):
    """Define the functional operator ``umics::<schema>``: on CUDA tensors
    :func:`launch` of ``run``, on CPU tensors ``cpu``, under fake tensors
    (``torch.export``) ``fake`` -> the op's default overload, unchecked."""
    name = schema.split("(", 1)[0]
    register_launch(name, run, route)
    _UMICS.define(schema)
    _UMICS.impl(name, lambda *operands: launch(name, *operands), "CUDA")
    _UMICS.impl(name, cpu, "CPU")
    torch.library.register_fake(f"umics::{name}", fake, lib=_UMICS)
    return getattr(torch.ops.umics, name).default
