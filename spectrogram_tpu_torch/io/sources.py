"""PCM sources: files, synthesis, and (gated) live capture.

Host-side equivalent of the reference's capture layer
(src/devices/audio_input_list_model.rs): produce stereo f32 frames and feed
them into the ingest rings.  Channel adaptation follows the reference exactly
(:66-76): mono duplicates into both channels, stereo passes through, other
channel counts are rejected.

Live microphone capture needs the `sounddevice` package (not present in this
image); it is gated behind `CaptureSource.available()` the same way the
reference's cpal path depends on an OS audio service.

A copy of `spectrogram_tpu/io/sources.py` (numpy and `wave` only; the JAX
package's module cannot be imported without JAX).
`tests/test_torch_io.py` pins it against the original.
"""

from __future__ import annotations

import dataclasses
import pathlib
import wave
from typing import Iterator, Optional

import numpy as np


def adapt_channels(block: np.ndarray) -> np.ndarray:
    """[n] or [n, c] samples -> [n, 2] stereo f32.

    Mono duplicates (audio_input_list_model.rs:68), stereo passes through
    (:70-72), anything else is an error (:74 prints a complaint; we raise).
    """
    block = np.asarray(block, dtype=np.float32)
    if block.ndim == 1:
        block = block[:, None]
    if block.shape[1] == 1:
        return np.repeat(block, 2, axis=1)
    if block.shape[1] == 2:
        return np.ascontiguousarray(block)
    raise ValueError(f"unsupported channel count {block.shape[1]} (only 1 or 2)")


@dataclasses.dataclass
class WavSource:
    """Streaming WAV file reader (stdlib `wave`; 16/24/32-bit PCM + float32)."""

    path: str | pathlib.Path

    def __post_init__(self):
        with wave.open(str(self.path), "rb") as w:
            self.sample_rate = float(w.getframerate())
            self.channels = w.getnchannels()
            self.sample_width = w.getsampwidth()
            self.num_frames = w.getnframes()
        if self.channels not in (1, 2):
            raise ValueError(f"unsupported channel count {self.channels}")

    def _decode(self, raw: bytes) -> np.ndarray:
        if self.sample_width == 2:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif self.sample_width == 4:
            # Heuristic: wave reports only PCM; treat 32-bit as int32.
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif self.sample_width == 3:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif self.sample_width == 1:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported sample width {self.sample_width}")
        return x.reshape(-1, self.channels)

    def blocks(self, block_frames: int = 4096) -> Iterator[np.ndarray]:
        """Yield [n, 2] stereo blocks."""
        with wave.open(str(self.path), "rb") as w:
            while True:
                raw = w.readframes(block_frames)
                if not raw:
                    return
                yield adapt_channels(self._decode(raw))

    def read_all(self) -> np.ndarray:
        return np.concatenate(list(self.blocks()), axis=0)


def write_wav(path, pcm: np.ndarray, sample_rate: float) -> None:
    """[n, 2] f32 -> 16-bit stereo WAV (test fixture / demo output helper)."""
    pcm = adapt_channels(pcm)
    data = np.clip(pcm * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(data.tobytes())


@dataclasses.dataclass
class SineSource:
    """Stereo test tone: left = sine at `freq_left`, right at `freq_right`."""

    sample_rate: float = 48_000.0
    freq_left: float = 440.0
    freq_right: float = 440.0
    amplitude: float = 0.5
    _phase: int = 0

    def next_block(self, n: int) -> np.ndarray:
        t = (self._phase + np.arange(n)) / self.sample_rate
        self._phase += n
        return np.stack(
            [
                self.amplitude * np.sin(2 * np.pi * self.freq_left * t),
                self.amplitude * np.sin(2 * np.pi * self.freq_right * t),
            ],
            axis=-1,
        ).astype(np.float32)


@dataclasses.dataclass
class ChirpSource:
    """Exponential sweep f0 -> f1 over `duration` seconds, both channels."""

    sample_rate: float = 48_000.0
    f0: float = 100.0
    f1: float = 10_000.0
    duration: float = 5.0
    amplitude: float = 0.5
    _phase: int = 0

    def next_block(self, n: int) -> np.ndarray:
        idx = (self._phase + np.arange(n)) % int(self.duration * self.sample_rate)
        t = idx / self.sample_rate
        self._phase += n
        k = np.log(self.f1 / self.f0) / self.duration
        phase = 2 * np.pi * self.f0 * (np.exp(k * t) - 1.0) / k
        x = (self.amplitude * np.sin(phase)).astype(np.float32)
        return np.stack([x, x], axis=-1)


@dataclasses.dataclass
class NoiseSource:
    """Gaussian noise (throughput benchmarking)."""

    amplitude: float = 0.1
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def next_block(self, n: int) -> np.ndarray:
        return (
            self._rng.standard_normal((n, 2)).astype(np.float32) * self.amplitude
        )


class CaptureSource:
    """Live microphone capture via sounddevice (optional dependency).

    The host-side analog of the reference's cpal input stream
    (audio_input_list_model.rs:64-82): a real-time callback pushes adapted
    stereo frames into a StereoRing / RingBank.
    """

    @staticmethod
    def available() -> bool:
        try:
            import sounddevice  # noqa: F401

            return True
        except ImportError:
            return False

    @staticmethod
    def list_devices():
        """Input device descriptions, default first (the reference sorts the
        default device to the top, audio_input_list_model.rs:120-124)."""
        import sounddevice as sd

        devices = [
            {"index": i, "name": d["name"], "sample_rate": d["default_samplerate"]}
            for i, d in enumerate(sd.query_devices())
            if d["max_input_channels"] > 0
        ]
        try:
            default = sd.default.device[0]
            devices.sort(key=lambda d: d["index"] != default)
        except Exception:
            pass
        return devices

    def __init__(self, ring, device: Optional[int] = None, sample_rate: Optional[float] = None):
        import sounddevice as sd

        info = sd.query_devices(device, "input")
        self.sample_rate = float(sample_rate or info["default_samplerate"])
        channels = min(int(info["max_input_channels"]), 2)
        self.overflows = 0  # upstream capture loss, counted (never silent)

        def callback(indata, frames, time_info, status):  # real-time thread
            if status and status.input_overflow:
                # PortAudio dropped frames BEFORE the ring; count it so the
                # no-silent-drops guarantee holds end to end.
                self.overflows += 1
            ring.push(adapt_channels(indata[:, :channels]))

        self._stream = sd.InputStream(
            device=device,
            channels=channels,
            samplerate=self.sample_rate,
            dtype="float32",
            callback=callback,
        )

    def start(self):
        self._stream.start()

    def stop(self):
        self._stream.stop()

    def close(self):
        self._stream.close()
