"""Input registry: device/source management for streams.

Host-side analog of the reference's device layer (C2/C3 in SURVEY.md §2):
`AudioInputListModel` (src/devices/audio_input_list_model.rs) enumerates
inputs with the default first, opens/pauses capture streams on `select`, and
exposes a `sample-rate` property consumed by the visualizer; `AudioDevice`
(src/devices/audio_device.rs) wraps a device handle with a `name`.

Here an `InputDescriptor` is the plain-dataclass device wrapper, and
`InputRegistry` the list model: it enumerates capture devices when
`sounddevice` exists plus always-available synthetic sources, and `select()`
performs the pause -> reconfigure -> restart dance (:35-83) against a
StereoRing.  `StreamBatch` is the scale-out face: S logical streams over one
native RingBank, each attachable to its own source.

A copy of `spectrogram_tpu/io/registry.py` on the port's `io.ring` and
`io.sources`; `tests/test_torch_io.py` pins it against the original.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from spectrogram_tpu_torch.io.ring import RingBank, StereoRing
from spectrogram_tpu_torch.io.sources import (
    CaptureSource,
    ChirpSource,
    NoiseSource,
    SineSource,
    WavSource,
    adapt_channels,
)


@dataclasses.dataclass(frozen=True)
class InputDescriptor:
    """Device/source handle with a display name (audio_device.rs analog)."""

    name: str
    kind: str  # "capture" | "synthetic" | "file"
    sample_rate: float
    device_index: Optional[int] = None
    factory: Optional[Callable] = None


class _SourcePump(threading.Thread):
    """Feeds a pull-style synthetic/file source into a ring in real time,
    standing in for the OS audio callback thread."""

    def __init__(self, source, ring, sample_rate: float, block: int = 1024):
        super().__init__(daemon=True)
        self._source = source
        self._ring = ring
        self._dt = block / sample_rate
        self._block = block
        self._halt = threading.Event()

    def run(self):
        # Deadline-based pacing: sleeping a fixed dt AFTER each push would
        # run systematically below real time (dt + push cost + sleep
        # overshoot per block) and slowly starve the consumer.
        next_t = time.monotonic()
        while not self._halt.is_set():
            self._ring.push(self._source.next_block(self._block))
            next_t += self._dt
            delay = next_t - time.monotonic()
            if delay > 0:
                self._halt.wait(delay)
            else:
                next_t = time.monotonic()  # fell behind; resync

    def stop(self, join: bool = True):
        # NOTE: the event is named _halt because threading.Thread has an
        # INTERNAL _stop() method that join() calls — shadowing it with an
        # Event makes join() raise.
        self._halt.set()
        if join and self.is_alive():
            # Join before a new pump starts: two producers on one SPSC ring
            # would violate the native ring's memory-order contract.
            self.join(timeout=2.0)


class InputRegistry:
    """Enumerate inputs; select one to stream into a ring.

    `on_sample_rate` mirrors the reference's `sample-rate` property notify
    (audio_input_list_model.rs:53-54): called whenever selection changes the
    rate, so the pipeline can re-specialize (new FFT plan).
    """

    def __init__(
        self,
        ring_capacity: int = 4096,  # audio_input_list_model.rs:30
        on_sample_rate: Optional[Callable[[float], None]] = None,
    ):
        self.ring = StereoRing(ring_capacity)
        self.on_sample_rate = on_sample_rate
        self.sample_rate: Optional[float] = None
        self._active: Optional[object] = None
        self._inputs = self._enumerate()

    def _enumerate(self) -> list[InputDescriptor]:
        inputs: list[InputDescriptor] = []
        if CaptureSource.available():
            for d in CaptureSource.list_devices():  # default-first order
                inputs.append(
                    InputDescriptor(
                        name=d["name"],
                        kind="capture",
                        sample_rate=float(d["sample_rate"]),
                        device_index=d["index"],
                    )
                )
        inputs.extend(
            [
                InputDescriptor(
                    "Test: 440 Hz stereo tone",
                    "synthetic",
                    48_000.0,
                    factory=lambda: SineSource(48_000.0, 440.0, 660.0),
                ),
                InputDescriptor(
                    "Test: exponential chirp",
                    "synthetic",
                    48_000.0,
                    factory=lambda: ChirpSource(48_000.0),
                ),
                InputDescriptor(
                    "Test: white noise",
                    "synthetic",
                    48_000.0,
                    factory=lambda: NoiseSource(),
                ),
            ]
        )
        return inputs

    def __len__(self) -> int:
        return len(self._inputs)

    def __getitem__(self, i: int) -> InputDescriptor:
        return self._inputs[i]

    @property
    def inputs(self) -> list[InputDescriptor]:
        return list(self._inputs)

    def select(self, index: int) -> InputDescriptor:
        """Stop the active stream, open the chosen one (pause -> reconfigure
        -> play, audio_input_list_model.rs:35-83)."""
        self.stop()
        desc = self._inputs[index]
        if desc.kind == "capture":
            src = CaptureSource(self.ring, device=desc.device_index)
            src.start()
            self._active = src
            rate = src.sample_rate
        else:
            source = desc.factory()
            pump = _SourcePump(source, self.ring, desc.sample_rate)
            pump.start()
            self._active = pump
            rate = desc.sample_rate
        if rate != self.sample_rate:
            self.sample_rate = rate
            if self.on_sample_rate:
                self.on_sample_rate(rate)
        return desc

    def stop(self):
        if self._active is None:
            return
        stop = getattr(self._active, "stop", None)
        if stop:
            stop()
        # Capture streams hold OS audio handles; stop() only pauses them.
        close = getattr(self._active, "close", None)
        if close:
            close()
        self._active = None


class StreamBatch:
    """S logical streams over one native RingBank, for the batched pipeline.

    attach() wires a source to a stream slot; tick() pumps every attached
    source once (for offline/batch feeding); pop_chunk() drains a lockstep
    [S, n, 2] block for the device.
    """

    def __init__(self, n_streams: int, ring_capacity: int = 16384):
        self.bank = RingBank(n_streams, ring_capacity)
        self.n_streams = n_streams
        self._sources: dict[int, object] = {}
        self._attached: set[int] = set()

    def attach(self, stream: int, source) -> None:
        if not 0 <= stream < self.n_streams:
            raise IndexError(stream)
        self._sources[stream] = source
        self._attached.add(stream)

    def attach_all(self, factory: Callable[[int], object]) -> None:
        for s in range(self.n_streams):
            self.attach(s, factory(s))

    def tick(self, n_frames: int) -> None:
        """Pull n_frames from every attached source into its ring."""
        for s, src in self._sources.items():
            self.bank.push(s, adapt_channels(src.next_block(n_frames)))

    def push(self, stream: int, frames: np.ndarray) -> int:
        return self.bank.push(stream, frames)

    def ready_chunks(self, chunk_frames: int) -> int:
        """How many full lockstep chunks every ATTACHED stream can supply.

        Unattached slots are excluded: they never receive samples, so
        including them would pin readiness at zero forever after a partial
        attach (their rings stay empty; pop zero-fills them).
        """
        if not self._attached:
            return 0
        if len(self._attached) == self.n_streams:
            return self.bank.min_size() // chunk_frames
        m = min(self.bank.size(s) for s in self._attached)
        return m // chunk_frames

    def pop_chunk(self, n_frames: int, out: Optional[np.ndarray] = None):
        return self.bank.pop_matrix(n_frames, out)

    @property
    def dropped_total(self) -> int:
        return self.bank.dropped_total
