"""Build, load and count the hand-written CUDA kernels.

The sources in `spectrogram_tpu_torch/csrc/` have a plain C interface: `nvcc`
compiles them, for `sm_90a` (Hopper), into one shared library, and `ctypes`
loads it.  No PyTorch header is compiled, so a cold build takes seconds.  The
library lands in `build/kernels/` beside the package (a directory git
ignores) and is rebuilt whenever the sources or flags change.

Nothing here runs at import time: the first kernel launch builds the library.
`KernelLibrary.launches` counts each kernel's launches, so that a run can show
that its main path went through the kernels.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> ctypes argtypes of its C entry point (see csrc/*.cu).
KERNELS = {
    "spk_stft_packed": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "spk_colormap_builtin": (
        _P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F, _P, _P,
    ),
}


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


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
    tmp = build_dir / f"{LIBRARY_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC_DIR.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)      # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    return lib, seconds


class KernelLibrary:
    """The loaded kernel library: one launch function per kernel, each of
    which raises on a refused launch and counts the launches it made."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self._dll = ctypes.CDLL(str(path))
        for name, argtypes in KERNELS.items():
            fn = getattr(self._dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._dll.spk_error_string.argtypes = (ctypes.c_int,)
        self._dll.spk_error_string.restype = ctypes.c_char_p
        self.launches = {name: 0 for name in KERNELS}

    def launch(self, name: str, *args) -> None:
        """Call kernel `name`'s C entry point (which launches it and returns
        cudaGetLastError()); raise if the launch was refused."""
        code = getattr(self._dll, name)(*args)
        if code != 0:
            msg = self._dll.spk_error_string(code).decode()
            raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")
        self.launches[name] += 1

    def reset_launches(self) -> None:
        for name in self.launches:
            self.launches[name] = 0


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    return KernelLibrary(build()[0])
