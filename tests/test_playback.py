"""Playback adapter tests: the shared SamplesSource chunk stream, gapless
continuity across file boundaries, sink selection, and the audio-device sink.

Covers the playback layer of reference src/playback.rs:3-66 and
src/main.rs:115-301 with mock sinks (no audio device or ffplay needed) —
the gapless contract is that consecutive files' untrimmed streaming chunks
appended to one sink form one continuous stream (main.rs:152-161).
"""

import sys
import types

import numpy as np
import pytest

from utils import generate_sine_wave

from glc import Decoder, Encoder, save_encoded
from glc.playback import (
    AudioDeviceSink,
    SamplesSource,
    audio_device_available,
    play_files_gapless,
    stream_playlist_sources,
)


class MockSink:
    """Collects everything appended; records close order."""

    def __init__(self, sample_rate, channels, log=None):
        self.sample_rate = sample_rate
        self.channels = channels
        self.parts = []
        self.closed = False
        self.log = log if log is not None else []
        self.log.append(self)

    def write(self, samples):
        self.parts.append(np.asarray(samples, np.float32))
        return True

    def append(self, source):
        return self.write(source.remaining())

    def close(self):
        self.closed = True
        return 0

    def samples(self):
        return np.concatenate(self.parts) if self.parts else np.empty(0)


@pytest.fixture(scope="module")
def two_glc_files(tmp_path_factory):
    """Two short mono .glc files with different tones."""
    d = tmp_path_factory.mktemp("playback")
    paths = []
    for i, freq in enumerate((440.0, 880.0)):
        s = generate_sine_wave(freq, 44100, 1, 0.5)
        ea = Encoder(44100).encode(s, 1)
        p = d / f"tone{i}.glc"
        save_encoded(ea, p)
        paths.append(p)
    return paths


def test_samples_source_iter_and_remaining():
    src = SamplesSource(np.arange(6, dtype=np.float32), 44100, 2)
    assert next(src) == 0.0 and next(src) == 1.0
    rest = src.remaining()
    assert rest.tolist() == [2.0, 3.0, 4.0, 5.0]
    with pytest.raises(StopIteration):
        next(src)
    # rodio::Source metadata parity (playback.rs:44-66)
    assert src.current_frame_len() is None
    assert src.total_duration() is None


def test_stream_sources_gapless_continuity(two_glc_files):
    """Chunks from the shared source, appended back-to-back, must equal the
    per-file untrimmed streaming outputs concatenated — sample-exact gapless
    joins at the file boundary (main.rs:152-161)."""
    streamed = []
    meta = []
    for src in stream_playlist_sources(
        two_glc_files, on_file=lambda p, r, c: meta.append((p.name, r, c))
    ):
        streamed.append(src.remaining())
    streamed = np.concatenate(streamed)

    expected_parts = []
    from glc import load_encoded

    for p in two_glc_files:
        ea = load_encoded(p)
        rx = Decoder(ea.header.channels, ea.header.sample_rate).decode_streaming(ea)
        while True:
            chunk = rx.get()
            assert chunk.error is None
            expected_parts.append(chunk.samples)
            if chunk.is_last:
                break
    expected = np.concatenate(expected_parts)

    np.testing.assert_array_equal(streamed, expected)
    assert meta == [("tone0.glc", 44100, 1), ("tone1.glc", 44100, 1)]


def test_stream_sources_stop_event(two_glc_files):
    import threading

    stop = threading.Event()
    got = 0
    for _src in stream_playlist_sources(two_glc_files, stop=stop):
        got += 1
        stop.set()
    assert got == 1  # aborted after the first chunk


def test_play_files_gapless_mock_sink(two_glc_files, capsys):
    """The gapless player feeds one sink across file boundaries and closes
    it once (same rate/channels → no sink restart)."""
    log = []
    play_files_gapless(
        two_glc_files, sink_factory=lambda r, c: MockSink(r, c, log)
    )
    assert len(log) == 1  # one sink for the whole same-format playlist
    sink = log[0]
    assert sink.closed
    assert (sink.sample_rate, sink.channels) == (44100, 1)
    # both files' untrimmed streams arrived: two files, >= 2 chunks
    assert len(sink.parts) >= 2
    out = capsys.readouterr().out
    assert "Playing 2 files gaplessly" in out
    assert "Playback finished" in out


def test_play_files_gapless_restarts_sink_on_format_change(
    two_glc_files, tmp_path
):
    s = generate_sine_wave(440.0, 48000, 1, 0.25)
    ea = Encoder(48000).encode(s, 1)
    p48 = tmp_path / "tone48k.glc"
    save_encoded(ea, p48)

    log = []
    play_files_gapless(
        [two_glc_files[0], p48],
        sink_factory=lambda r, c: MockSink(r, c, log),
    )
    assert [s.sample_rate for s in log] == [44100, 48000]
    assert all(s.closed for s in log)


def test_play_files_gapless_empty_raises():
    with pytest.raises(ValueError):
        play_files_gapless([])


def _fake_sounddevice():
    """A minimal fake of the sounddevice API used by AudioDeviceSink."""
    mod = types.ModuleType("sounddevice")
    written = []

    class OutputStream:
        def __init__(self, samplerate, channels, dtype):
            self.samplerate = samplerate
            self.channels = channels
            self.dtype = dtype
            self.started = False
            self.closed = False

        def start(self):
            self.started = True

        def write(self, data):
            written.append(np.asarray(data))

        def stop(self):
            self.started = False

        def close(self):
            self.closed = True

    mod.OutputStream = OutputStream
    mod._written = written
    return mod


def test_audio_device_sink_sounddevice(monkeypatch):
    fake = _fake_sounddevice()
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    assert audio_device_available()

    sink = AudioDeviceSink(44100, 2)
    assert sink.backend_name == "sounddevice"
    src = SamplesSource(np.arange(8, dtype=np.float32), 44100, 2)
    assert sink.append(src)
    assert sink.close() == 0
    (chunk,) = fake._written
    assert chunk.shape == (4, 2)  # interleaved → frames × channels


def test_audio_device_sink_unavailable(monkeypatch):
    for name in ("sounddevice", "simpleaudio"):
        monkeypatch.setitem(sys.modules, name, None)  # import → ImportError
    assert not audio_device_available()
    with pytest.raises(RuntimeError):
        AudioDeviceSink(44100, 2)
