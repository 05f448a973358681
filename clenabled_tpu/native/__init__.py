"""Native C++ runtime components (ctypes bindings).

The reference's entire runtime is C++; the pieces that remain host-side
here — high-rate ingest, unpack/marshal, disk output — are native
here too:

- :class:`RingBuffer` — SPSC lock-free sample ring (capture thread ↔ JAX
  dispatch thread decoupling; the role of GR buffers / the reference's
  pinned double buffers).
- unpack/marshal — packed-4-bit & signed-byte I/Q → planar float pairs,
  plus the X-Engine [time][station][chan][pol] marshal
  (lib/clXEngine_impl.cc:831-858, :982-1061).
- :class:`RollingFileWriter` — async rolling output files with JSON
  sidecars (lib/clXEngine_impl.cc:438-465).

The shared library is compiled from ``src/*.cc`` with g++ -O3 at first use
into ``_build/`` (no pip deps); if no compiler is available the pure-NumPy
fallbacks keep the unpack/marshal API working.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
# build outputs live here (listed in .gitignore); nothing built is committed
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_SOURCES = ("ringbuffer.cc", "unpack.cc", "filewriter.cc")
_CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def lib_path() -> str:
    """Where the library for the current sources lives.  The name carries
    a hash of the sources' contents and the compiler flags, so a changed
    source builds a new library and a stale one is never loaded."""
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for f in _SOURCES:
        with open(os.path.join(_SRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"_clenabled_native-{h.hexdigest()[:16]}.so")


def _build(path: str) -> str | None:
    srcs = [os.path.join(_SRC_DIR, f) for f in _SOURCES]
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name, then rename: concurrent builders (test
    # workers) each produce a whole file and the last rename wins
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *_CXXFLAGS, "-o", tmp, *srcs, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        return getattr(e, "stderr", None) or str(e)
    os.replace(tmp, path)
    return None


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build_error = _build(path)
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(path)
        lib.rb_create.restype = ctypes.c_void_p
        lib.rb_create.argtypes = [ctypes.c_size_t]
        lib.rb_destroy.argtypes = [ctypes.c_void_p]
        for fn in ("rb_write", "rb_read"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_size_t
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        for fn in ("rb_available", "rb_space", "rb_capacity"):
            f = getattr(lib, fn)
            f.restype = ctypes.c_size_t
            f.argtypes = [ctypes.c_void_p]
        lib.unpack_4bit_planar.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        lib.unpack_i8_planar.argtypes = lib.unpack_4bit_planar.argtypes
        lib.deinterleave_c64.argtypes = lib.unpack_4bit_planar.argtypes
        lib.interleave_c64.argtypes = lib.unpack_4bit_planar.argtypes
        lib.marshal_xengine_planar.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t]
        lib.fw_create.restype = ctypes.c_void_p
        lib.fw_create.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p]
        lib.fw_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_size_t]
        lib.fw_queue_depth.restype = ctypes.c_size_t
        lib.fw_queue_depth.argtypes = [ctypes.c_void_p]
        lib.fw_file_count.restype = ctypes.c_int
        lib.fw_file_count.argtypes = [ctypes.c_void_p]
        lib.fw_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_error() -> str | None:
    get_lib()
    return _build_error


class RingBuffer:
    """SPSC byte ring buffer backed by the native implementation."""

    def __init__(self, capacity: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.rb_create(capacity)
        if not self._h:
            raise MemoryError("rb_create failed")

    @property
    def capacity(self) -> int:
        return self._lib.rb_capacity(self._h)

    def available(self) -> int:
        return self._lib.rb_available(self._h)

    def space(self) -> int:
        return self._lib.rb_space(self._h)

    def write(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data)
        return self._lib.rb_write(self._h, data.ctypes.data, data.nbytes)

    def read(self, nbytes: int, dtype=np.uint8) -> np.ndarray:
        out = np.empty(nbytes, np.uint8)
        got = self._lib.rb_read(self._h, out.ctypes.data, nbytes)
        return out[:got].view(dtype)

    def close(self):
        if self._h:
            self._lib.rb_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def unpack_4bit_planar(raw: np.ndarray):
    """Packed 4-bit I/Q bytes → (re, im) float32 (native, host-side)."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.uint8)
    n = raw.size
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    if lib is None:
        from clenabled_tpu.dsp.xengine import _TWOS_LUT
        re[:] = _TWOS_LUT[raw >> 4] / 7.0
        im[:] = _TWOS_LUT[raw & 0xF] / 7.0
        return re, im
    lib.unpack_4bit_planar(raw.ctypes.data, re.ctypes.data, im.ctypes.data, n)
    return re, im


def unpack_i8_planar(raw: np.ndarray):
    """Interleaved signed-byte I/Q → (re, im) float32 (native)."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, np.int8)
    n = raw.size // 2
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    if lib is None:
        f = raw.astype(np.float32) / 127.0
        re[:] = f[0::2]
        im[:] = f[1::2]
        return re, im
    lib.unpack_i8_planar(raw.ctypes.data, re.ctypes.data, im.ctypes.data, n)
    return re, im


def marshal_xengine_planar(station_blocks, n_time: int, chan_pol: int):
    """[station][time*chan*pol] float32 blocks → [time, station, chan*pol]."""
    lib = get_lib()
    blocks = [np.ascontiguousarray(b, np.float32) for b in station_blocks]
    s = len(blocks)
    out = np.empty((n_time, s, chan_pol), np.float32)
    if lib is None:
        for si, b in enumerate(blocks):
            out[:, si, :] = b.reshape(n_time, chan_pol)
        return out
    ptrs = (ctypes.c_void_p * s)(*[b.ctypes.data for b in blocks])
    lib.marshal_xengine_planar(ptrs, out.ctypes.data, s, n_time, chan_pol)
    return out


class RollingFileWriter:
    """Async rolling binary writer with JSON sidecars (native thread)."""

    def __init__(self, base: str, rollover_bytes: int = 0,
                 sidecar_json: str = ""):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.fw_create(base.encode(), rollover_bytes,
                                sidecar_json.encode())

    def write(self, data: np.ndarray):
        data = np.ascontiguousarray(data)
        self._lib.fw_write(self._h, data.ctypes.data, data.nbytes)

    def queue_depth(self) -> int:
        return self._lib.fw_queue_depth(self._h)

    def file_count(self) -> int:
        return self._lib.fw_file_count(self._h)

    def close(self):
        if self._h:
            self._lib.fw_close(self._h)
            self._h = None
