"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/torch_kernels/`` at the root of the checkout, then loaded with
``ctypes``.  A library is named after a hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads as built.  Nothing
here runs at import time: the first launch builds, or a caller (the chip
smoke script) builds every kernel up front with :func:`build`, one
``nvcc`` per source, all started together.  A failed build raises; there
is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("int4_matmul", "flash_attention", "paged_attention", "int8_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_held = threading.local()


class LaunchCount:
    """Number of times a wrapper launched its kernel."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        """Count ``n`` launches, or hold them back while this thread is
        inside :func:`held_launches`."""
        held = getattr(_held, "counts", None)
        if held is not None:
            held[self] = held.get(self, 0) + n
            return
        with self._lock:
            self._n += n

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


@contextlib.contextmanager
def held_launches() -> Iterator[Dict[LaunchCount, int]]:
    """Launches that this thread's wrappers make inside the block are not
    counted: the block yields them as ``{counter: n}``.  A CUDA graph's
    warm-up and capture run inside it, so that only its replays count
    (:mod:`..pipeline.graphs`)."""
    outer = getattr(_held, "counts", None)
    held: Dict[LaunchCount, int] = {}
    _held.counts = held
    try:
        yield held
    finally:
        _held.counts = outer


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def toolkit_program(name: str) -> str:
    """A program of the CUDA toolkit that holds ``nvcc`` (``cuobjdump``)."""
    path = Path(_nvcc()).parent / name
    if not path.exists():
        raise RuntimeError(f"{name} not found beside {_nvcc()}")
    return str(path)


def library_path(name: str) -> Path:
    text = b"".join(f.read_bytes() for f in
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_report(name: str) -> str:
    """nvcc's output for the built library of ``csrc/<name>.cu``: its
    ``-Xptxas -v`` registers, shared memory and spills per kernel."""
    path = library_path(name)
    return path.with_name(path.name + ".log").read_text()


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile each named source that has no library yet, all ``nvcc``
    processes started together; returns the wall seconds spent (0.0 when
    everything was built already).  Raises on any compiler error."""
    with _lock:
        todo = [(n, library_path(n)) for n in names]
        todo = [(n, out) for n, out in todo if not out.exists()]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = []
        for n, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for n, out, tmp, p in procs:
            text, _ = p.communicate()
            if p.returncode:
                errors.append(f"{n}.cu: nvcc exited {p.returncode}\n{text}")
            else:
                out.with_name(out.name + ".log").write_text(text)
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        return time.perf_counter() - t0


def library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use;
    ``declare`` sets ``argtypes``/``restype`` of its functions once."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.nns_error_string.argtypes = [ctypes.c_int]
                lib.nns_error_string.restype = ctypes.c_char_p
                declare(lib)
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (``cudaGetLastError()``
    right after the launch, as the C function returns it)."""
    if rc:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.nns_error_string(rc).decode()})")
