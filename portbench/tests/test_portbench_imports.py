"""Nothing the benchmark runs imports JAX or the JAX package, top-level
names compared whole (`spectrogram_tpu_torch` begins with
`spectrogram_tpu`); the reference imports nothing of the program."""

import ast
import subprocess
import sys

from conftest import ROOT

from portbench import harness

PKG = ROOT / "portbench"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = list(PKG.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not top_level_imports(path) & set(harness.BARRED), path


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert "spectrogram_tpu_torch" not in names and not names & set(harness.BARRED), path


def test_barred_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "spectrogram_tpu_torchx", sys)
    assert "spectrogram_tpu_torchx" not in harness.barred_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.barred_modules() == ["jax.numpy"]


def test_a_rehearsal_loads_no_barred_module():
    code = ("import sys; sys.path.insert(0, 'portbench/tests'); import conftest;"
            "from portbench import harness;"
            "conftest.rehearse(conftest.tiny_cell('ref2k.k8.ring.mixed'), seconds=0.2);"
            "print(harness.barred_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_without_a_card_and_prints_nothing():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "svc16k.k1.device", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        return
    assert out.returncode != 0 and out.stdout == ""


def test_run_fails_where_only_the_benchmark_is(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone: no program, so
    no result and a nonzero exit."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = "import portbench.harness as h; h.program()"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
