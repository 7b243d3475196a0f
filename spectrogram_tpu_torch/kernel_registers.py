"""Registers, stack and spills of the hand-written kernels, as ptxas reports them.

    python -m spectrogram_tpu_torch.kernel_registers [--match TEXT] [SOURCE ...]

Compiles each named source of `spectrogram_tpu_torch/csrc/` (default: every
`*.cu`; a name without its `.cu`, e.g. `stft_packed`) with the flags of
`ops/cuda/_build.py` and `-Xptxas -v`, one nvcc per source, all started
together, and prints one line per kernel instantiation: its source, its
registers, its stack frame and spill bytes, and its demangled name
(through `c++filt` where it is installed).  `--match` keeps the lines
whose name contains TEXT (e.g. `Radix2`).  It needs `nvcc`, not a card.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile

from spectrogram_tpu_torch.ops.cuda import _build

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return [re.sub(r"\(anonymous namespace\)::|\(.*", "", n) for n in out]


def report(sources: list[str]) -> list[tuple[str, str, int, tuple[int, int, int]]]:
    """(source, kernel, registers, (stack, spill stores, spill loads)) of
    every kernel entry in the sources."""
    nvcc = _build._nvcc()
    flags = [f for f in _build.COMPILE_FLAGS if f != "-c"]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {
            src: subprocess.Popen(
                [nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", f"{tmp}/{src}.cubin",
                 str(_build.CSRC_DIR / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources
        }
        rows = []
        for src, proc in procs.items():
            text = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}.cu:\n{text}")
            entry = frame = None
            for line in text.splitlines():
                if m := _ENTRY.search(line):
                    entry = m.group(1)
                elif m := _FRAME.search(line):
                    frame = tuple(int(g) for g in m.groups())
                elif (m := _REGS.search(line)) and entry is not None:
                    rows.append((src, entry, int(m.group(1)), frame or (0, 0, 0)))
                    entry = frame = None
    names = _demangle([r[1] for r in rows])
    return [(src, name, regs, frame) for (src, _, regs, frame), name in zip(rows, names)]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="*")
    parser.add_argument("--match", default="")
    args = parser.parse_args(argv)
    sources = args.sources or sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    for src, name, regs, (stack, stores, loads) in report(sources):
        if args.match in name:
            print(f"{src}: {regs} registers, stack {stack} B, spill {stores}/{loads} B  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
