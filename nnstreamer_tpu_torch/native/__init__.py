"""Native (C++) support: the helper library and the C API, built with g++.

Port of ``nnstreamer_tpu/native/__init__.py``.  The port keeps its own
copies of the JAX package's C++ sources and headers (``src/``,
``include/``; the ABI and every C signature are the JAX package's, so a
``.so`` filter or a C program written for one package builds against the
other unchanged).  Two libraries are built from them:

* ``libnnstpu`` from ``src/nnstpu.cpp`` (plain C++, loaded with ``ctypes``
  by :func:`load`): :func:`crc32`, :func:`strip_stride`,
  :func:`wire_gather`, :func:`wire_check` and :class:`ShmRing`;
* ``libnnstpu_capi`` from ``src/nnstpu_capi.cpp``: the C API of
  ``include/nnstpu_capi.h``, which embeds CPython and calls
  :mod:`nnstreamer_tpu_torch.capi`.  C programs link it
  (:func:`program_job`); nothing in Python loads it.

Both are compiled by ``g++`` into ``build/torch_native/`` at the root of
the checkout, beside the CUDA kernels' ``build/torch_kernels/``, each
named after a hash of its sources and flags, so an edited source rebuilds
and an unchanged one loads as built.  Nothing is built at import time: the
first :func:`load` builds, or a caller builds up front with :func:`build`
(the chip smoke script does, beside the ``nvcc`` builds).  A failed build
raises with g++'s output; there is no Python fallback.

Which path each of the port's callers takes:

* the wire codec (``utils/wire.py``) keeps ``zlib.crc32`` and one
  ``b"".join`` for its frames: the same bytes as :func:`wire_gather` and
  the same verdict as :func:`wire_check` (the tests hold all three
  equal), with no build on a server's first frame;
* ``tensor_converter`` keeps numpy's strided copy for the row-stride
  strip, the bytes :func:`strip_stride` gives;
* ``shmsink`` / ``shmsrc`` keep ``elements/shm.py``'s ring in Python over
  ``multiprocessing.shared_memory``, which has this ring's layout: the
  tests pass buffers between the two, both ways, across two processes.

Those elements were measured on the card on their Python paths, and no
hot path of the port waits on ``g++``; this module serves C users, the
interop tests and the smoke script.  So the JAX package's ``available()``
and ``prewarm()``, which chose between the library and a fallback, have
no counterpart.  The JAX module's ``V4L2Capture`` is not bound: the
character-device ``v4l2src`` waits for a machine with a ``/dev/video*``
node (its C++ is in the copied source, unused).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
import time
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
INCLUDE = HERE / "include"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
LIBRARIES = ("nnstpu", "nnstpu_capi")
#: the longest one g++ may take
COMPILE_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def embed_flags() -> Tuple[List[str], List[str]]:
    """(compile, link) flags that embed the RUNNING interpreter: its
    include directory and ``-lpython<version>`` from its ``LIBDIR`` (a
    ``python3-config`` on the PATH may describe another Python, whose
    site-packages lack torch), found at run time through an rpath.  Not
    through ``LD_LIBRARY_PATH``: that would put ``LIBDIR``, often a
    system directory, ahead of the run paths of torch's own libraries,
    and a system cuDNN, say, would be loaded in place of torch's."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = (sysconfig.get_config_var("LDVERSION")
           or f"{sys.version_info.major}.{sys.version_info.minor}")
    return ([f"-I{sysconfig.get_paths()['include']}"],
            [f"-L{libdir}", f"-lpython{ver}", "-ldl", "-lm", f"-Wl,-rpath,{libdir}"])


def _digest(paths: Sequence[Path], flags: Sequence[str]) -> str:
    text = b"".join(Path(p).read_bytes() for p in paths)
    return hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]


def _library_job(name: str) -> Tuple[Path, List[str]]:
    if name == "nnstpu":
        src, flags = SRC / "nnstpu.cpp", ["-O3", "-lrt"]
        deps = [src]
    elif name == "nnstpu_capi":
        cflags, ldflags = embed_flags()
        src, flags = SRC / "nnstpu_capi.cpp", ["-O2", *cflags, *ldflags]
        deps = [src, INCLUDE / "nnstpu_capi.h"]
    else:
        raise ValueError(f"no native library {name!r}: one of {LIBRARIES}")
    flags = ["-shared", "-fPIC", "-std=c++17", *flags]
    out = BUILD_DIR / f"lib{name}-{_digest(deps, flags)}.so"
    # sources before libraries: the linker resolves left to right
    return out, ["g++", str(src), *flags]


def library_path(name: str) -> Path:
    """Where ``lib<name>`` is (or will be) built."""
    return _library_job(name)[0]


def filter_job(source: Path, out_dir: Path = BUILD_DIR) -> Tuple[Path, List[str]]:
    """A ``.so`` filter for ``framework=custom`` from a C or C++ source
    against the port's ``include/``."""
    source = Path(source)
    cc = "gcc" if source.suffix == ".c" else "g++"
    flags = ["-O2", "-shared", "-fPIC", f"-I{INCLUDE}"]
    out = Path(out_dir) / f"lib{source.stem}-{_digest([source], flags)}.so"
    return out, [cc, str(source), *flags]


def program_job(source: Path, out_dir: Path = BUILD_DIR) -> Tuple[Path, List[str]]:
    """A C or C++ program against the C API: it includes
    ``nnstpu_capi.h`` and links the port's ``libnnstpu_capi``, found at
    run time through its rpath.  Run it with ``PYTHONPATH`` reaching this
    package and torch (:func:`program_env`)."""
    source = Path(source)
    lib = library_path("nnstpu_capi")
    _, ldflags = embed_flags()
    flags = ["-O2", f"-I{INCLUDE}", str(lib), *ldflags, f"-Wl,-rpath,{lib.parent}"]
    out = Path(out_dir) / f"{source.stem}-{_digest([source], flags)}"
    return out, ["gcc" if source.suffix == ".c" else "g++", str(source), *flags]


def program_env(env: Optional[dict] = None) -> dict:
    """The environment a C API program needs: ``PYTHONPATH`` holding the
    root of this checkout and the running interpreter's path (an embedded
    interpreter derives its prefix from the program, not from
    ``python3``, so a virtual environment's site-packages could be
    missing).  ``libpython`` is found through the program's rpath."""
    env = dict(os.environ if env is None else env)
    root = str(Path(__file__).resolve().parents[2])
    paths = [root] + [p for p in sys.path if p and p != root]
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def compile_all(jobs: Iterable[Tuple[Path, List[str]]]) -> float:
    """Run each job ``(out, command)`` whose ``out`` does not exist yet,
    all compilers started together, each writing a temporary file that
    replaces ``out`` when it succeeds; returns the wall seconds (0.0 when
    every output was there).  Raises with the compiler's output when one
    fails."""
    todo = [(Path(out), cmd) for out, cmd in jobs if not Path(out).exists()]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    procs = []
    for out, cmd in todo:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        procs.append((out, tmp, cmd, subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for out, tmp, cmd, p in procs:
        try:
            text, _ = p.communicate(timeout=COMPILE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            errors.append(f"{' '.join(cmd)}: timed out after {COMPILE_TIMEOUT_S} s\n{text}")
            continue
        if p.returncode:
            errors.append(f"{' '.join(cmd)}: exited {p.returncode}\n{text}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def build(names: Iterable[str] = LIBRARIES) -> float:
    """Compile each named library that is not built yet (all ``g++``
    processes started together); the wall seconds, 0.0 when every one was
    built.  Raises with g++'s output on a failure."""
    return compile_all(_library_job(n) for n in names)


def load() -> ctypes.CDLL:
    """``libnnstpu``, built on first use, its functions declared."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build(("nnstpu",))
        lib = ctypes.CDLL(str(library_path("nnstpu")))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.nns_crc32.restype = ctypes.c_uint32
        lib.nns_crc32.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.nns_strip_stride.restype = None
        lib.nns_strip_stride.argtypes = [u8p, u8p, ctypes.c_uint64, ctypes.c_uint64,
                                         ctypes.c_uint64]
        lib.nns_wire_frame_size.restype = ctypes.c_uint64
        lib.nns_wire_frame_size.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32]
        lib.nns_wire_gather.restype = None
        lib.nns_wire_gather.argtypes = [
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32, u8p]
        lib.nns_wire_check.restype = ctypes.c_int
        lib.nns_wire_check.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.nns_ring_create.restype = ctypes.c_void_p
        lib.nns_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64]
        lib.nns_ring_open.restype = ctypes.c_void_p
        lib.nns_ring_open.argtypes = [ctypes.c_char_p]
        lib.nns_ring_slot_bytes.restype = ctypes.c_uint64
        lib.nns_ring_slot_bytes.argtypes = [ctypes.c_void_p]
        lib.nns_ring_nslots.restype = ctypes.c_uint32
        lib.nns_ring_nslots.argtypes = [ctypes.c_void_p]
        lib.nns_ring_acquire.restype = u8p
        lib.nns_ring_acquire.argtypes = [ctypes.c_void_p]
        lib.nns_ring_commit.restype = ctypes.c_int
        lib.nns_ring_commit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.nns_ring_peek.restype = u8p
        lib.nns_ring_peek.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
        lib.nns_ring_release.restype = None
        lib.nns_ring_release.argtypes = [ctypes.c_void_p]
        lib.nns_ring_closed.restype = ctypes.c_int
        lib.nns_ring_closed.argtypes = [ctypes.c_void_p]
        lib.nns_ring_close.restype = None
        lib.nns_ring_close.argtypes = [ctypes.c_void_p]
        lib.nns_ring_free.restype = None
        lib.nns_ring_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _to_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


# -- crc32 -------------------------------------------------------------------

def crc32(data, seed: int = 0) -> int:
    """zlib's CRC-32 of ``data`` (bytes or an array's bytes), chained
    from ``seed``."""
    a = _to_u8(data)
    return int(load().nns_crc32(_as_u8p(a), a.nbytes, seed))


# -- stride repack -----------------------------------------------------------

def strip_stride(src, rows: int, row_bytes: int, src_stride: int) -> np.ndarray:
    """Copy ``rows`` rows of ``row_bytes`` out of a strided byte buffer
    (video frames whose rowstride != width*bpp — reference:
    gsttensor_converter.c stride removal)."""
    flat = _to_u8(src)
    if flat.nbytes < rows * src_stride - (src_stride - row_bytes):
        raise ValueError("source smaller than rows*stride")
    out = np.empty(rows * row_bytes, np.uint8)
    load().nns_strip_stride(_as_u8p(flat), _as_u8p(out), rows, row_bytes, src_stride)
    return out


# -- wire gather -------------------------------------------------------------

def wire_gather(segments: list):
    """Assemble segments into one frame: ``u64 len | payload | u32 crc``.

    Returns a memoryview over the frame (``socket.sendall`` and slicing
    both accept it)."""
    lib = load()
    arrs = [_to_u8(s) for s in segments]
    n = len(arrs)
    lens = (ctypes.c_uint64 * n)(*[a.nbytes for a in arrs])
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (u8p * n)(*[_as_u8p(a) for a in arrs])
    out = np.empty(int(lib.nns_wire_frame_size(lens, n)), np.uint8)
    lib.nns_wire_gather(ptrs, lens, n, _as_u8p(out))
    return out.data


def wire_check(payload, crc: int) -> bool:
    a = _to_u8(payload)
    return bool(load().nns_wire_check(_as_u8p(a), a.nbytes, crc))


# -- shared-memory ring ------------------------------------------------------

class ShmRing:
    """SPSC shared-memory ring of fixed-size slots (same-host IPC), the
    C++ ring of ``src/nnstpu.cpp``; ``elements/shm.py`` has its layout in
    Python, and either end may be either one.

    Producer: ``ring = ShmRing.create(name, nslots, slot_bytes)`` then
    ``ring.try_put(bytes)``.  Consumer (other process):
    ``ShmRing.open(name)`` then ``ring.try_get()``."""

    def __init__(self, handle, name: str):
        self._h = handle
        self.name = name
        self._lib = load()

    @classmethod
    def create(cls, name: str, nslots: int = 8, slot_bytes: int = 1 << 20) -> "ShmRing":
        h = load().nns_ring_create(name.encode(), nslots, slot_bytes)
        if not h:
            raise OSError(f"shm ring create failed for {name!r}")
        return cls(h, name)

    @classmethod
    def open(cls, name: str) -> "ShmRing":
        h = load().nns_ring_open(name.encode())
        if not h:
            raise OSError(f"shm ring open failed for {name!r} (producer not up?)")
        return cls(h, name)

    @property
    def slot_bytes(self) -> int:
        return int(self._lib.nns_ring_slot_bytes(self._h))

    @property
    def nslots(self) -> int:
        return int(self._lib.nns_ring_nslots(self._h))

    def try_put(self, data) -> bool:
        a = _to_u8(data)
        if a.nbytes > self.slot_bytes:
            raise ValueError(f"payload {a.nbytes}B > slot {self.slot_bytes}B")
        slot = self._lib.nns_ring_acquire(self._h)
        if not slot:
            return False
        ctypes.memmove(slot, a.ctypes.data, a.nbytes)
        return bool(self._lib.nns_ring_commit(self._h, a.nbytes))

    def try_get(self) -> Optional[bytes]:
        ln = ctypes.c_uint64()
        p = self._lib.nns_ring_peek(self._h, ctypes.byref(ln))
        if not p:
            return None
        data = ctypes.string_at(p, ln.value)
        self._lib.nns_ring_release(self._h)
        return data

    @property
    def closed(self) -> bool:
        return bool(self._lib.nns_ring_closed(self._h))

    def close_write(self) -> None:
        self._lib.nns_ring_close(self._h)

    def free(self) -> None:
        if self._h:
            self._lib.nns_ring_free(self._h)
            self._h = None
