"""The port's CLI against the JAX package's, on the CPU (`--device cpu`).

Mirrors `tests/test_app_cli.py`: the argparse surface end to end.  The same
arguments go to `spectrogram_tpu.app.main` and
`spectrogram_tpu_torch.app.main`.  The bars:

  * `palettes` and `inputs` print JAX's text exactly;
  * `render` writes JAX's image within 1 u8 per channel (mono palettes, so
    the composite shows every channel), the golden render likewise;
  * `render_ansi`, `downsample`, `save_png` on equal numpy inputs give
    JAX's output exactly;
  * `live` (headless, with `--view`, and with `--view --multirate`) exits
    0 and writes a PNG of the viewport's shape.
"""

import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from spectrogram_tpu import app as japp
from spectrogram_tpu.utils import image as jimage
from spectrogram_tpu.utils import terminal as jterm

from spectrogram_tpu_torch import app
from spectrogram_tpu_torch.io.sources import SineSource, write_wav
from spectrogram_tpu_torch.utils import image as timage
from spectrogram_tpu_torch.utils import terminal as tterm

torch.set_num_threads(2)

CPU = ["--device", "cpu"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def test_palettes_and_inputs(capsys):
    assert app.main(["palettes"]) == 0
    out = capsys.readouterr().out
    assert "Magma" in out and "Oranges" in out and out.count("\n") == 19
    assert japp.main(["palettes"]) == 0
    assert capsys.readouterr().out == out
    assert app.main(["inputs"]) == 0
    out = capsys.readouterr().out
    assert "chirp" in out
    assert japp.main(["inputs"]) == 0
    assert capsys.readouterr().out == out


def test_render_from_wav(tmp_path, capsys):
    wav = tmp_path / "tone.wav"
    write_wav(wav, SineSource(8000.0, 500.0, 500.0).next_block(4000), 8000)
    args = [str(wav), "--window", "0.032", "--hop", "0.016", "--height", "64",
            "--palette", "Viridis"]
    assert app.main(["render", args[0], str(tmp_path / "out.png"), *args[1:], *CPU]) == 0
    assert "wrote" in capsys.readouterr().out
    assert japp.main(["render", args[0], str(tmp_path / "jax.png"), *args[1:]]) == 0
    got, want = _png(tmp_path / "out.png"), _png(tmp_path / "jax.png")
    assert got.shape == want.shape == (64, 30, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_render_synthetic_golden(tmp_path):
    args = ["--golden", "--seconds", "0.2", "--sample-rate", "8000",
            "--window", "0.032", "--hop", "0.016", "--height", "48"]
    rc = app.main(["render", "--source", "sine", str(tmp_path / "g.png"), *args, *CPU])
    assert rc == 0
    assert japp.main(["render", "--source", "sine", str(tmp_path / "j.png"), *args]) == 0
    got, want = _png(tmp_path / "g.png"), _png(tmp_path / "j.png")
    assert got.shape == want.shape == (48, 11, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_render_file_requires_input():
    with pytest.raises(SystemExit):
        app.main(["render", "out.png", "--source", "file", *CPU])


def test_device_defaults_to_the_card(tmp_path):
    """`--device` defaults to cuda; without a card the CLI exits non-zero
    and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    out = tmp_path / "x.png"
    with pytest.raises(SystemExit, match="--device cpu"):
        app.main(["render", "--source", "sine", str(out), "--seconds", "0.1"])
    assert not out.exists()


def test_top_level_exports():
    import spectrogram_tpu_torch as sg

    assert sg.SpectrogramPipeline.__name__ == "SpectrogramPipeline"
    assert sg.LiveSession.__name__ == "LiveSession"
    assert sg.StreamGroupManager.__name__ == "StreamGroupManager"
    with pytest.raises(AttributeError):
        sg.nonexistent_symbol


def test_render_ansi_frame():
    img = np.zeros((64, 40, 3), np.uint8)
    img[:32] = [255, 0, 0]      # top half red
    img[32:] = [0, 0, 255]      # bottom half blue
    frame = tterm.render_ansi(img, cols=20, rows=8)
    assert frame == jterm.render_ansi(img, cols=20, rows=8)
    assert frame.startswith("\x1b[H")
    lines = [l for l in frame.split("\n") if l]
    assert len(lines) == 8
    assert frame.count("▀") == 20 * 8
    assert lines[0].count("38;2;255;0;0") == 1
    rng = np.random.default_rng(2)
    noisy = rng.integers(0, 256, (37, 23, 3), dtype=np.uint8)
    assert tterm.render_ansi(noisy, 11, 7) == jterm.render_ansi(noisy, 11, 7)


def test_terminal_viewer_no_tty_is_noop():
    import io

    buf = io.StringIO()
    with tterm.TerminalViewer(cols=10, rows=4, stream=buf) as tv:
        tv.draw(np.zeros((8, 8, 3), np.uint8), status="x")
        assert list(tv.keys()) == []
    assert buf.getvalue() == ""


def test_downsample_and_odd_sizes():
    img = np.arange(7 * 13 * 3, dtype=np.uint8).reshape(7, 13, 3)
    out = tterm.downsample(img, 3, 5)
    np.testing.assert_array_equal(out, jterm.downsample(img, 3, 5))
    assert out.shape == (3, 5, 3)
    np.testing.assert_array_equal(out[0, 0], img[0, 0])
    np.testing.assert_array_equal(out[-1, -1], img[-1, -1])
    assert tterm.render_ansi(img, cols=5, rows=3).count("▀") == 15


def test_save_png_equals_jax(tmp_path):
    rows = np.random.default_rng(3).integers(0, 256, (9, 17, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timage.rows_to_image(rows), jimage.rows_to_image(rows))
    timage.save_png(tmp_path / "t.png", rows)
    jimage.save_png(tmp_path / "j.png", rows)
    np.testing.assert_array_equal(_png(tmp_path / "t.png"), _png(tmp_path / "j.png"))
    assert _png(tmp_path / "t.png").shape == (17, 9, 3)


LIVE = ["--sample-rate", "8000", "--window", "0.032", "--hop", "0.008", "--height", "64"]


@pytest.mark.parametrize("view", [[], ["--view", "--fps", "100"]])
def test_live_runs_headless(tmp_path, view):
    """The streaming loop (and with --view, the render cadence code behind
    the no-op sink) writes the final viewport: 2,048 rows of 64 pixels."""
    out = tmp_path / "v.png"
    rc = app.main(["live", str(out), "--seconds", "0.3", "--streams", "2", *LIVE,
                   *view, *CPU])
    assert rc == 0 and _png(out).shape == (64, 2048, 3)


def test_live_view_multirate_headless(tmp_path):
    """Two geometry groups behind StreamGroupManager ticks, tiled frames,
    the headless sink; the PNG is the focused group's viewport."""
    out = tmp_path / "mr.png"
    rc = app.main(["live", str(out), "--seconds", "0.5", "--streams", "4",
                   "--sample-rate", "9000", "--window", "0.032", "--hop", "0.008",
                   "--height", "64", "--view", "--multirate", "--fps", "50",
                   "--chunk-hops", "2", *CPU])
    assert rc == 0 and _png(out).shape == (64, 2048, 3)
    with pytest.raises(SystemExit):
        app.main(["live", str(out), "--streams", "1", "--view", "--multirate", *CPU])


def test_module_runs_and_leaves_jax_out(tmp_path):
    """`python -m spectrogram_tpu_torch.app` in a fresh interpreter renders
    without importing JAX or the JAX package."""
    out = tmp_path / "m.png"
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['app', 'render', '--source', 'chirp', {str(out)!r}, '--seconds', "
        "'0.2', '--sample-rate', '8000', '--window', '0.032', '--hop', '0.016', "
        "'--height', '32', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('spectrogram_tpu_torch.app', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spectrogram_tpu' or m.startswith('spectrogram_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=ROOT)
    assert _png(out).shape == (32, 11, 3)
