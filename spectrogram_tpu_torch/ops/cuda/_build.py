"""Build, load and count the hand-written CUDA kernels.

The sources in `spectrogram_tpu_torch/csrc/` have a plain C interface: one
`nvcc` per source, all started together, compiles each for `sm_90a`
(Hopper); one more links the objects into a shared library, and `ctypes`
loads it.  No PyTorch header is compiled, so a cold build takes seconds.  The
library lands in `build/kernels/` beside the package (a directory git
ignores) and is rebuilt whenever the sources or flags change.

Nothing here runs at import time: the first kernel launch builds the library.
`KernelLibrary.launches` counts each kernel's launches, and
`KernelLibrary.body_launches` the STFT launches by FFT body (radix 2, mixed
radix, Bluestein, and the large-N route), so that a run can show that its
main path went through the kernels and bodies; `KernelLibrary.build_s` is
the seconds nvcc took to build the library the process loaded (0.0 where
the build was current).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
LIBRARY_NAME = "libspectrogram_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> ctypes argtypes of its C entry point (see csrc/*.cu).  The STFT
# entries, the fused push and the tile colormaps take a launch choice before
# the stream (the bounds, `stft_kernel.LAUNCH_BOUNDS`, or the tile's form,
# `colormap_kernel.TILE_FORMS`; 0 the table's rule).
_STFT = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)
_ALLK = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
_ALLK_CARRY = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)
_LARGE = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P)
KERNELS = {
    "spk_stft_packed": _STFT,
    "spk_stft_packed_i16": _STFT,
    "spk_stft_mixed": _STFT,
    "spk_stft_mixed_i16": _STFT,
    "spk_stft_allk": _ALLK,
    "spk_stft_allk_i16": _ALLK,
    "spk_stft_allk_carry": _ALLK_CARRY,
    "spk_stft_allk_carry_i16": _ALLK_CARRY,
    "spk_stft_split": _STFT,
    "spk_stft_split_allk": _ALLK,
    "spk_stft_split_allk_carry": _ALLK_CARRY,
    "spk_stft_split_carry": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "spk_stft_split_t": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "spk_stft_split_tsplit": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # the large-N route: window planes, hann, table, scratch, planes
    "spk_stft_large_packed": _LARGE,
    "spk_stft_large_packed_i16": _LARGE,
    "spk_stft_large_split": _LARGE,
    "spk_push_fused": (
        _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _F, _F, _F, _F, _P, _P,
        _P, _I, _I, _I, _I, _P,
    ),
    # kernel B, the blockwise colormap and the generic kernel take the taps'
    # span after the bins
    "spk_colormap_builtin": (
        _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _F, _F, _F,
        _P, _I, _P,
    ),
    "spk_colormap_blockwise": (
        _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _F, _F,
        _F, _P, _I, _P,
    ),
    "spk_colormap_generic": (
        _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _F, _F,
        _F, _P, _I, _P,
    ),
    # the two table pointers are host memory, copied into the kernel's
    # parameters (the second null for a built-in table)
    "spk_colormap_static": (
        _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I, _F, _F, _F, _F, _P, _P,
    ),
    # the planar rows take the taps' span after the bins
    "spk_colormap_rows": (
        _P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _F, _F, _F, _F, _P, _I, _P,
    ),
    # planes, their row stride, S, k, B; the ring, its dtype code and its
    # stream and row strides, R; the cursor on the device
    "spk_ring_write": (_P, _P, _L, _I, _I, _I, _P, _I, _L, _L, _I, _P, _P),
}
# the STFT kernels' FFT bodies (csrc/stft_fft.cuh, `stft_kernel.fft_body`),
# and the large-N route (csrc/stft_large.cu) under its own label
# (`stft_kernel.fft_route`)
FFT_BODIES = ("radix2", "mixed", "bluestein", "large")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the "
            "CUDA kernels of spectrogram_tpu_torch need the CUDA toolkit"
        )
    return str(path)


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the output of the first that
    fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


def build(build_dir: pathlib.Path = BUILD_DIR) -> tuple[pathlib.Path, float]:
    """Compile csrc/*.cu into `build_dir/libspectrogram_kernels.so` unless an
    up-to-date build is there.  Returns (library path, seconds spent
    compiling; 0.0 when the build was current)."""
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / LIBRARY_NAME
    stamp = build_dir / (LIBRARY_NAME + ".sha256")
    digest = _source_digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, 0.0
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
    tmp = build_dir / f"{LIBRARY_NAME}.{tag}"
    t0 = time.perf_counter()
    try:
        _run([[nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
              for src, obj in zip(sources, objects)])
        _run([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]])
        os.replace(tmp, lib)      # atomic: a concurrent loader sees old or new
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    stamp.write_text(digest)
    return lib, time.perf_counter() - t0


class KernelLibrary:
    """The loaded kernel library: one launch function per kernel, each of
    which raises on a refused launch and counts the launches it made."""

    def __init__(self, path: pathlib.Path, build_s: float = 0.0):
        self.path = path
        self.build_s = build_s        # nvcc's wall seconds, 0.0 for a current build
        self._dll = ctypes.CDLL(str(path))
        for name, argtypes in KERNELS.items():
            fn = getattr(self._dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._dll.spk_error_string.argtypes = (ctypes.c_int,)
        self._dll.spk_error_string.restype = ctypes.c_char_p
        self.launches = {name: 0 for name in KERNELS}
        self.body_launches = {body: 0 for body in FFT_BODIES}

    def launch(self, name: str, *args, body: str | None = None) -> None:
        """Call kernel `name`'s C entry point (which launches it and returns
        cudaGetLastError()); raise if the launch was refused.  An STFT
        launch names the FFT `body` it runs, counted beside the kernel."""
        code = getattr(self._dll, name)(*args)
        if code != 0:
            msg = self._dll.spk_error_string(code).decode()
            raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")
        self.launches[name] += 1
        if body is not None:
            self.body_launches[body] += 1

    def reset_launches(self) -> None:
        for counts in (self.launches, self.body_launches):
            for name in counts:
                counts[name] = 0


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    return KernelLibrary(*build())
