"""Python bindings for the native host-ingest ring buffers.

Wraps `spectrogram_tpu_torch/native/ring_buffer.cpp` (a copy of the JAX
package's source, which `tests/test_torch_io.py` holds byte for byte) via
ctypes.  The classes, their methods and their checks are the JAX package's
`io/ring.py`; the loader is the port's own:

  * the first ring built compiles the source with g++ and the JAX
    Makefile's flags into `build/host/libspectrogram_ring.so` beside the
    package (a directory git ignores), and rebuilds it whenever the
    source's or the flags' hash changes, as `ops/cuda/_build.py` does for
    the kernels;
  * the compiler writes a per-process temporary file that is renamed over
    the library, so that concurrent builds (test workers, several services
    on one host) never load a half-written binary;
  * a failed build raises, with the compiler's output: there is no stale
    binary to fall back on and no quiet switch to the numpy ring.

The numpy ring in `StereoRing` and `RingBank` is the plain version of the
native one.  It runs only where `_load_library` is replaced by a function
that returns None, as the tests do; `RingBank16` has no plain version.

API mirrors the reference's transport layer semantics (SPSC, peek/skip,
counted drops — see the C++ header comment for the file-level mapping).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "native" / "ring_buffer.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "host"
LIBRARY_NAME = "libspectrogram_ring.so"
CXX = "g++"
# the JAX package's Makefile: CXXFLAGS, then -shared -pthread
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")
BUILD_TIMEOUT_S = 120
_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()

_u64 = ctypes.c_uint64
_f32p = ctypes.POINTER(ctypes.c_float)
_u64p = ctypes.POINTER(_u64)


def _digest() -> str:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build(build_dir: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Compile `native/ring_buffer.cpp` into `build_dir` (default
    `BUILD_DIR`) unless an up-to-date build is there; return the library's
    path.  Raises RuntimeError with the compiler's output if it fails."""
    build_dir = pathlib.Path(build_dir or BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / LIBRARY_NAME
    stamp = build_dir / (LIBRARY_NAME + ".sha256")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    tag = f"{os.getpid()}.tmp"
    tmp_lib = build_dir / f"{LIBRARY_NAME}.{tag}"
    tmp_stamp = build_dir / f"{LIBRARY_NAME}.sha256.{tag}"
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp_lib), str(SOURCE)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(
                f"building the native ring library failed: {' '.join(cmd)}: {exc}"
            ) from exc
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native ring library failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}"
            )
        # atomic renames: a concurrent loader sees the old library or the new
        os.replace(tmp_lib, lib)
        tmp_stamp.write_text(digest)
        os.replace(tmp_stamp, stamp)
    finally:
        tmp_lib.unlink(missing_ok=True)
        tmp_stamp.unlink(missing_ok=True)
    return lib


def _load_library() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; raises if it cannot be
    built or loaded."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        # signatures
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [_u64]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        for name in ("ring_capacity", "ring_size", "ring_dropped"):
            getattr(lib, name).restype = _u64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("ring_push", "ring_pop", "ring_peek"):
            getattr(lib, name).restype = _u64
            getattr(lib, name).argtypes = [ctypes.c_void_p, _f32p, _u64]
        lib.ring_skip.restype = _u64
        lib.ring_skip.argtypes = [ctypes.c_void_p, _u64]
        lib.bank_create.restype = ctypes.c_void_p
        lib.bank_create.argtypes = [_u64, _u64]
        lib.bank_destroy.argtypes = [ctypes.c_void_p]
        lib.bank_capacity.restype = _u64
        lib.bank_capacity.argtypes = [ctypes.c_void_p]
        lib.bank_push.restype = _u64
        lib.bank_push.argtypes = [ctypes.c_void_p, _u64, _f32p, _u64]
        lib.bank_push_matrix.argtypes = [ctypes.c_void_p, _f32p, _u64]
        lib.bank_pop_matrix.argtypes = [ctypes.c_void_p, _f32p, _u64, _u64p]
        lib.bank_push_matrix_mt.argtypes = [ctypes.c_void_p, _f32p, _u64, _u64]
        lib.bank_pop_matrix_mt.argtypes = [
            ctypes.c_void_p, _f32p, _u64, _u64p, _u64
        ]
        lib.bank_pop_matrix_planar_mt.argtypes = [
            ctypes.c_void_p, _f32p, _u64, _u64p, _u64
        ]
        lib.bank_pop_matrix_mt_perm.argtypes = [
            ctypes.c_void_p, _f32p, _u64, _u64p, _u64, _u64p
        ]
        lib.bank_pop_matrix_planar_mt_perm.argtypes = [
            ctypes.c_void_p, _f32p, _u64, _u64p, _u64, _u64p
        ]
        lib.bank_min_size.restype = _u64
        lib.bank_min_size.argtypes = [ctypes.c_void_p]
        lib.bank_size.restype = _u64
        lib.bank_size.argtypes = [ctypes.c_void_p, _u64]
        lib.bank_dropped_total.restype = _u64
        lib.bank_dropped_total.argtypes = [ctypes.c_void_p]
        lib.bank_dropped.restype = _u64
        lib.bank_dropped.argtypes = [ctypes.c_void_p, _u64]
        _LIB = lib
        return lib


def native_available() -> bool:
    """True when the native library is loaded (building it if needed).
    False only where `_load_library` is replaced by one that returns None
    (the numpy ring); a failed build raises."""
    return _load_library() is not None


def _check_out(out, shape) -> np.ndarray:
    """Validate a caller-supplied output buffer before handing its pointer to
    C: wrong dtype/shape/strides would mean silent memory corruption."""
    if out is None:
        return np.empty(shape, np.float32)
    if (
        out.dtype != np.float32
        or out.shape != shape
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(
            f"out buffer must be C-contiguous float32 {shape}; got "
            f"{out.dtype} {out.shape} contiguous={out.flags['C_CONTIGUOUS']}"
        )
    return out


def _check_dest(dest, n_streams: int) -> Optional[np.ndarray]:
    """Validate a destination-row permutation for the permuted drains: a
    uint64 [S] permutation of range(S).  Stream s's frames land in output
    row dest[s] — the host-sorted chunk order for palette-sorted pipelines
    (`SpectrogramPipeline.input_dest`).  A non-permutation would race two
    streams onto one output row in the multithreaded native copy, and an
    entry >= S would write past the buffer, so every pop that takes `dest`
    validates it (O(S) host work; callers cache the array itself and
    re-derive it after each set_palette)."""
    if dest is None:
        return None
    dest = np.ascontiguousarray(dest, dtype=np.uint64)
    if dest.shape != (n_streams,):
        raise ValueError(f"dest must be [{n_streams}]; got {dest.shape}")
    if n_streams and int(dest.max()) >= n_streams:
        raise ValueError(
            f"dest entries must lie in [0, {n_streams}); got {int(dest.max())}"
        )
    seen = np.zeros(n_streams, bool)
    seen[dest] = True
    if not seen.all():
        raise ValueError("dest must be a permutation of range(n_streams)")
    return dest


def _as_frames(frames: np.ndarray) -> np.ndarray:
    frames = np.ascontiguousarray(frames, dtype=np.float32)
    if frames.ndim != 2 or frames.shape[1] != 2:
        raise ValueError(f"expected [n, 2] stereo frames, got {frames.shape}")
    return frames


class StereoRing:
    """SPSC ring of stereo f32 frames with counted drops (native-backed)."""

    def __init__(self, capacity: int = 4096):
        self._lib = _load_library()
        if self._lib is not None:
            self._handle = self._lib.ring_create(_u64(capacity))
            if not self._handle:
                raise MemoryError("ring_create failed")
            self.capacity = int(self._lib.ring_capacity(self._handle))
        else:  # the plain version: a numpy ring
            self._handle = None
            self.capacity = 1 << (max(capacity, 2) - 1).bit_length()
            self._buf = np.zeros((self.capacity, 2), np.float32)
            self._head = 0
            self._tail = 0
            self._dropped = 0
            self._lock = threading.Lock()

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._handle:
            self._lib.ring_destroy(self._handle)
            self._handle = None

    def __len__(self) -> int:
        if self._handle:
            return int(self._lib.ring_size(self._handle))
        return self._head - self._tail

    @property
    def dropped(self) -> int:
        if self._handle:
            return int(self._lib.ring_dropped(self._handle))
        return self._dropped

    def push(self, frames: np.ndarray) -> int:
        frames = _as_frames(frames)
        n = len(frames)
        if self._handle:
            return int(
                self._lib.ring_push(
                    self._handle, frames.ctypes.data_as(_f32p), _u64(n)
                )
            )
        with self._lock:
            free = self.capacity - (self._head - self._tail)
            accepted = min(n, free)
            self._dropped += n - accepted
            for i in range(accepted):
                self._buf[(self._head + i) % self.capacity] = frames[i]
            self._head += accepted
            return accepted

    def _read(self, n: int, destructive: bool) -> np.ndarray:
        if self._handle:
            out = np.empty((n, 2), np.float32)
            fn = self._lib.ring_pop if destructive else self._lib.ring_peek
            got = int(fn(self._handle, out.ctypes.data_as(_f32p), _u64(n)))
            return out[:got]
        with self._lock:
            avail = self._head - self._tail
            got = min(n, avail)
            idx = (self._tail + np.arange(got)) % self.capacity
            out = self._buf[idx].copy()
            if destructive:
                self._tail += got
            return out

    def pop(self, n: int) -> np.ndarray:
        return self._read(n, destructive=True)

    def peek(self, n: int) -> np.ndarray:
        """Non-destructive window read (audio_transform.rs peek semantics)."""
        return self._read(n, destructive=False)

    def skip(self, n: int) -> int:
        """Advance the read cursor (hop skip)."""
        if self._handle:
            return int(self._lib.ring_skip(self._handle, _u64(n)))
        with self._lock:
            got = min(n, self._head - self._tail)
            self._tail += got
            return got


_RESIDENT_BLOCK = 1024      # frames a stream per round of _make_resident


def _make_resident(bank, push, pop, dtype) -> None:
    """Write every page of a native bank's rings once, at construction:
    zeros pushed through the whole capacity and popped again.  A ring left
    as malloc returned it faults its pages in on the first hops a producer
    writes, inside the serving loop's schedule: at 10,240 streams x 8,192
    frames that held every producer 90-140 ms behind its hop on an 8-core
    H100 host, and the burst that followed overran the rings.  Afterwards
    the bank is as new (empty, nothing dropped, cursors at a multiple of
    the capacity)."""
    k = min(bank.capacity, _RESIDENT_BLOCK)
    zeros = np.zeros((bank.n_streams, k, 2), dtype)
    out = np.empty((bank.n_streams, 2, k), dtype)
    for _ in range(bank.capacity // k):
        push(zeros)
        pop(k, out)


class RingBank:
    """S uniform SPSC rings; one call fills a whole [S, n, 2] device batch.

    n_threads: worker threads for the batched matrix ops (stream ranges are
    independent, so this is race-free).  The single-threaded copy loop alone
    blows the 16.7 ms hop budget at 10k streams (measured 29 ms); the default
    scales workers with stream count.
    """

    def __init__(self, n_streams: int, capacity: int = 16384,
                 n_threads: Optional[int] = None):
        self.n_streams = int(n_streams)
        if n_threads is None:
            import os
            n_threads = min(max(self.n_streams // 1024, 1), os.cpu_count() or 1, 16)
        self.n_threads = int(n_threads)
        self._lib = _load_library()
        if self._lib is not None:
            self._handle = self._lib.bank_create(_u64(n_streams), _u64(capacity))
            if not self._handle:
                raise MemoryError("bank_create failed")
            self.capacity = int(self._lib.bank_capacity(self._handle))
            self._rings = None
            _make_resident(self, self.push_matrix, self.pop_matrix_planar, np.float32)
        else:
            self._handle = None
            self._rings = [StereoRing(capacity) for _ in range(n_streams)]
            self.capacity = self._rings[0].capacity if n_streams else 0

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._handle:
            self._lib.bank_destroy(self._handle)
            self._handle = None

    def push(self, stream: int, frames: np.ndarray) -> int:
        frames = _as_frames(frames)
        if self._handle:
            return int(
                self._lib.bank_push(
                    self._handle,
                    _u64(stream),
                    frames.ctypes.data_as(_f32p),
                    _u64(len(frames)),
                )
            )
        return self._rings[stream].push(frames)

    def push_matrix(self, frames: np.ndarray) -> None:
        """[S, n, 2] block: n frames to every stream."""
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        if frames.ndim != 3 or frames.shape[0] != self.n_streams or frames.shape[2] != 2:
            raise ValueError(f"expected [{self.n_streams}, n, 2], got {frames.shape}")
        if self._handle:
            self._lib.bank_push_matrix_mt(
                self._handle, frames.ctypes.data_as(_f32p),
                _u64(frames.shape[1]), _u64(self.n_threads),
            )
        else:
            for s in range(self.n_streams):
                self._rings[s].push(frames[s])

    def pop_matrix(self, n: int, out: Optional[np.ndarray] = None,
                   dest: Optional[np.ndarray] = None):
        """Pop n frames per stream into [S, n, 2] (zero-padded on underrun).

        Returns (out, counts) with counts[s] = frames actually popped for
        stream s.  `out` may be preallocated (pinned) to avoid per-tick
        allocation.  `dest` (optional [S] permutation): stream s's frames
        land in output row dest[s] — the host-sorted drain that lets
        palette-sorted pipelines (`presorted_input=True`) skip the
        device-side chunk gather; counts stay indexed by source stream.
        """
        out = _check_out(out, (self.n_streams, n, 2))
        counts = np.empty((self.n_streams,), np.uint64)
        dest = _check_dest(dest, self.n_streams)
        if self._handle:
            if dest is None:
                self._lib.bank_pop_matrix_mt(
                    self._handle,
                    out.ctypes.data_as(_f32p),
                    _u64(n),
                    counts.ctypes.data_as(_u64p),
                    _u64(self.n_threads),
                )
            else:
                self._lib.bank_pop_matrix_mt_perm(
                    self._handle,
                    out.ctypes.data_as(_f32p),
                    _u64(n),
                    counts.ctypes.data_as(_u64p),
                    _u64(self.n_threads),
                    dest.ctypes.data_as(_u64p),
                )
        else:
            for s in range(self.n_streams):
                got = self._rings[s].pop(n)
                counts[s] = len(got)
                d = int(dest[s]) if dest is not None else s
                out[d, : len(got)] = got
                out[d, len(got) :] = 0.0
        return out, counts

    def pop_matrix_planar(self, n: int, out: Optional[np.ndarray] = None,
                          dest: Optional[np.ndarray] = None):
        """Pop n frames per stream into PLANAR [S, 2, n] — the channels are
        deinterleaved during the host copy (free), so the device never pays
        the [S, n, 2] -> [S, 2, n] transpose before a planar push.  `dest`:
        see pop_matrix."""
        out = _check_out(out, (self.n_streams, 2, n))
        counts = np.empty((self.n_streams,), np.uint64)
        dest = _check_dest(dest, self.n_streams)
        if self._handle:
            if dest is None:
                self._lib.bank_pop_matrix_planar_mt(
                    self._handle,
                    out.ctypes.data_as(_f32p),
                    _u64(n),
                    counts.ctypes.data_as(_u64p),
                    _u64(self.n_threads),
                )
            else:
                self._lib.bank_pop_matrix_planar_mt_perm(
                    self._handle,
                    out.ctypes.data_as(_f32p),
                    _u64(n),
                    counts.ctypes.data_as(_u64p),
                    _u64(self.n_threads),
                    dest.ctypes.data_as(_u64p),
                )
        else:
            for s in range(self.n_streams):
                got = self._rings[s].pop(n)
                counts[s] = len(got)
                d = int(dest[s]) if dest is not None else s
                out[d, :, : len(got)] = got.T
                out[d, :, len(got) :] = 0.0
        return out, counts

    def min_size(self) -> int:
        if self._handle:
            return int(self._lib.bank_min_size(self._handle))
        return min((len(r) for r in self._rings), default=0)

    def size(self, stream: int) -> int:
        if self._handle:
            return int(self._lib.bank_size(self._handle, _u64(stream)))
        return len(self._rings[stream])

    @property
    def dropped_total(self) -> int:
        if self._handle:
            return int(self._lib.bank_dropped_total(self._handle))
        return sum(r.dropped for r in self._rings)

    def dropped(self, stream: int) -> int:
        if self._handle:
            return int(self._lib.bank_dropped(self._handle, _u64(stream)))
        return self._rings[stream].dropped


_i16p = ctypes.POINTER(ctypes.c_int16)


class RingBank16:
    """S uniform SPSC rings of int16 PCM; pops convert to f32 in one pass.

    PCM's native wire format is int16 — storing it that way halves ring
    memory and hop-tick read traffic (the host memory bus is the 10k-stream
    bottleneck of ingest; see DESIGN.md).  Native-only (no plain version):
    this class exists purely for ingest bandwidth.
    """

    def __init__(self, n_streams: int, capacity: int = 16384,
                 n_threads: Optional[int] = None):
        self._lib = _load_library()
        if self._lib is None:
            raise RuntimeError("RingBank16 requires the native library")
        # Always (re)bind: hasattr on a CDLL auto-creates unbound symbols, so
        # it cannot be used as a "bound yet?" check. Idempotent.
        self._bind16(self._lib)
        self.n_streams = int(n_streams)
        if n_threads is None:
            import os
            n_threads = min(max(self.n_streams // 1024, 1), os.cpu_count() or 1, 16)
        self.n_threads = int(n_threads)
        self._handle = self._lib.bank16_create(_u64(n_streams), _u64(capacity))
        if not self._handle:
            raise MemoryError("bank16_create failed")
        self.capacity = int(self._lib.bank16_capacity(self._handle))
        _make_resident(self, self.push_matrix, self.pop_matrix_i16_planar, np.int16)

    @staticmethod
    def _bind16(lib):
        lib.bank16_create.restype = ctypes.c_void_p
        lib.bank16_create.argtypes = [_u64, _u64]
        lib.bank16_destroy.argtypes = [ctypes.c_void_p]
        lib.bank16_capacity.restype = _u64
        lib.bank16_capacity.argtypes = [ctypes.c_void_p]
        lib.bank16_push.restype = _u64
        lib.bank16_push.argtypes = [ctypes.c_void_p, _u64, _i16p, _u64]
        lib.bank16_push_matrix_mt.argtypes = [
            ctypes.c_void_p, _i16p, _u64, _u64p, _u64
        ]
        lib.bank16_push_matrix_planar_mt.argtypes = [
            ctypes.c_void_p, _i16p, _u64, _u64p, _u64
        ]
        lib.bank16_push_matrix_range.argtypes = [
            ctypes.c_void_p, _u64, _u64, _i16p, _u64, _u64p
        ]
        lib.bank16_pop_matrix_f32.argtypes = [
            ctypes.c_void_p, _f32p, _u64, _u64p, _u64
        ]
        lib.bank16_pop_matrix_f32_planar.argtypes = [
            ctypes.c_void_p, _f32p, _u64, _u64p, _u64
        ]
        lib.bank16_pop_matrix_i16_planar.argtypes = [
            ctypes.c_void_p, _i16p, _u64, _u64p, _u64
        ]
        lib.bank16_pop_matrix_f32_perm.argtypes = [
            ctypes.c_void_p, _f32p, _u64, _u64p, _u64, _u64p
        ]
        lib.bank16_pop_matrix_f32_planar_perm.argtypes = [
            ctypes.c_void_p, _f32p, _u64, _u64p, _u64, _u64p
        ]
        lib.bank16_pop_matrix_i16_planar_perm.argtypes = [
            ctypes.c_void_p, _i16p, _u64, _u64p, _u64, _u64p
        ]
        lib.bank16_min_size.restype = _u64
        lib.bank16_min_size.argtypes = [ctypes.c_void_p]
        lib.bank16_reset.argtypes = [ctypes.c_void_p, _u64]
        lib.bank16_size.restype = _u64
        lib.bank16_size.argtypes = [ctypes.c_void_p, _u64]
        lib.bank16_dropped_total.restype = _u64
        lib.bank16_dropped_total.argtypes = [ctypes.c_void_p]

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.bank16_destroy(self._handle)
            self._handle = None

    def push(self, stream: int, frames_i16: np.ndarray) -> int:
        frames_i16 = np.ascontiguousarray(frames_i16, dtype=np.int16)
        if frames_i16.ndim != 2 or frames_i16.shape[1] != 2:
            raise ValueError(f"expected [n, 2] i16 frames, got {frames_i16.shape}")
        return int(self._lib.bank16_push(
            self._handle, _u64(stream),
            frames_i16.ctypes.data_as(_i16p), _u64(len(frames_i16)),
        ))

    def push_matrix(self, frames_i16: np.ndarray) -> np.ndarray:
        """[S, n, 2] int16 block: n frames to every stream in one native call
        (per-stream ctypes pushes cost ~5 us each — ruinous at 10k streams).
        Returns counts[S] = frames accepted per stream (drops are counted)."""
        frames_i16 = np.ascontiguousarray(frames_i16, dtype=np.int16)
        if (frames_i16.ndim != 3 or frames_i16.shape[0] != self.n_streams
                or frames_i16.shape[2] != 2):
            raise ValueError(
                f"expected [{self.n_streams}, n, 2] i16, got {frames_i16.shape}"
            )
        counts = np.empty((self.n_streams,), np.uint64)
        self._lib.bank16_push_matrix_mt(
            self._handle, frames_i16.ctypes.data_as(_i16p),
            _u64(frames_i16.shape[1]), counts.ctypes.data_as(_u64p),
            _u64(self.n_threads),
        )
        return counts

    def push_matrix_range(self, lo: int, frames_i16: np.ndarray) -> np.ndarray:
        """[hi-lo, n, 2] int16 block onto streams [lo, lo+len): the batched
        push for sharded producers (each producer thread owns a stream range
        — the SPSC contract allows exactly one producer per ring)."""
        frames_i16 = np.ascontiguousarray(frames_i16, dtype=np.int16)
        if frames_i16.ndim != 3 or frames_i16.shape[2] != 2:
            raise ValueError(f"expected [k, n, 2] i16, got {frames_i16.shape}")
        k = frames_i16.shape[0]
        if lo < 0 or lo + k > self.n_streams:
            raise ValueError(
                f"range [{lo}, {lo + k}) outside [0, {self.n_streams})"
            )
        counts = np.empty((k,), np.uint64)
        self._lib.bank16_push_matrix_range(
            self._handle, _u64(lo), _u64(lo + k),
            frames_i16.ctypes.data_as(_i16p), _u64(frames_i16.shape[1]),
            counts.ctypes.data_as(_u64p),
        )
        return counts

    def push_matrix_planar(self, frames_i16: np.ndarray) -> np.ndarray:
        """[S, 2, n] planar int16 block (decoders emitting planar PCM);
        channels are interleaved into the rings during the copy."""
        frames_i16 = np.ascontiguousarray(frames_i16, dtype=np.int16)
        if (frames_i16.ndim != 3 or frames_i16.shape[0] != self.n_streams
                or frames_i16.shape[1] != 2):
            raise ValueError(
                f"expected [{self.n_streams}, 2, n] i16, got {frames_i16.shape}"
            )
        counts = np.empty((self.n_streams,), np.uint64)
        self._lib.bank16_push_matrix_planar_mt(
            self._handle, frames_i16.ctypes.data_as(_i16p),
            _u64(frames_i16.shape[2]), counts.ctypes.data_as(_u64p),
            _u64(self.n_threads),
        )
        return counts

    def pop_matrix_f32(self, n: int, out: Optional[np.ndarray] = None,
                       dest: Optional[np.ndarray] = None):
        """Pop n frames per stream into f32 [S, n, 2] (x/32768 conversion
        fused into the copy), zero-padded on underrun.  `dest` (optional
        [S] permutation): stream s lands in output row dest[s] — the
        host-sorted drain (`SpectrogramPipeline.input_dest`); counts stay
        indexed by source stream."""
        out = _check_out(out, (self.n_streams, n, 2))
        counts = np.empty((self.n_streams,), np.uint64)
        dest = _check_dest(dest, self.n_streams)
        if dest is None:
            self._lib.bank16_pop_matrix_f32(
                self._handle, out.ctypes.data_as(_f32p), _u64(n),
                counts.ctypes.data_as(_u64p), _u64(self.n_threads),
            )
        else:
            self._lib.bank16_pop_matrix_f32_perm(
                self._handle, out.ctypes.data_as(_f32p), _u64(n),
                counts.ctypes.data_as(_u64p), _u64(self.n_threads),
                dest.ctypes.data_as(_u64p),
            )
        return out, counts

    def pop_matrix_f32_planar(self, n: int, out: Optional[np.ndarray] = None,
                              dest: Optional[np.ndarray] = None):
        """Planar [S, 2, n] f32 drain with fused i16->f32 conversion.
        `dest`: see pop_matrix_f32."""
        out = _check_out(out, (self.n_streams, 2, n))
        counts = np.empty((self.n_streams,), np.uint64)
        dest = _check_dest(dest, self.n_streams)
        if dest is None:
            self._lib.bank16_pop_matrix_f32_planar(
                self._handle, out.ctypes.data_as(_f32p), _u64(n),
                counts.ctypes.data_as(_u64p), _u64(self.n_threads),
            )
        else:
            self._lib.bank16_pop_matrix_f32_planar_perm(
                self._handle, out.ctypes.data_as(_f32p), _u64(n),
                counts.ctypes.data_as(_u64p), _u64(self.n_threads),
                dest.ctypes.data_as(_u64p),
            )
        return out, counts

    def pop_matrix_i16_planar(self, n: int, out: Optional[np.ndarray] = None,
                              dest: Optional[np.ndarray] = None):
        """Planar [S, 2, n] RAW int16 drain (no conversion): the wire-dtype
        path — push the int16 block to the device as-is (HALF the
        host->device bytes of the f32 drain) and let the push scale by
        1/32768 on the device (`SpectrogramPipeline.push*` accept int16
        chunks; an `i16_planes` pipeline keeps the words through its STFT
        kernel).  `dest`: see pop_matrix_f32."""
        if out is None:
            out = np.empty((self.n_streams, 2, n), np.int16)
        elif (out.shape != (self.n_streams, 2, n)
              or out.dtype != np.int16 or not out.flags.c_contiguous):
            raise ValueError(
                f"out must be C-contiguous int16 {(self.n_streams, 2, n)}"
            )
        counts = np.empty((self.n_streams,), np.uint64)
        dest = _check_dest(dest, self.n_streams)
        if dest is None:
            self._lib.bank16_pop_matrix_i16_planar(
                self._handle, out.ctypes.data_as(_i16p), _u64(n),
                counts.ctypes.data_as(_u64p), _u64(self.n_threads),
            )
        else:
            self._lib.bank16_pop_matrix_i16_planar_perm(
                self._handle, out.ctypes.data_as(_i16p), _u64(n),
                counts.ctypes.data_as(_u64p), _u64(self.n_threads),
                dest.ctypes.data_as(_u64p),
            )
        return out, counts

    def min_size(self) -> int:
        return int(self._lib.bank16_min_size(self._handle))

    def size(self, stream: int) -> int:
        return int(self._lib.bank16_size(self._handle, _u64(stream)))

    def reset(self, stream: int) -> None:
        """Discard everything buffered for one stream (slot reuse: the new
        tenant must not consume the previous tenant's backlog)."""
        self._lib.bank16_reset(self._handle, _u64(stream))

    @property
    def dropped_total(self) -> int:
        return int(self._lib.bank16_dropped_total(self._handle))
