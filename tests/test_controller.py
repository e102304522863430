"""Headless GUI controller tests (the logic of reference src/ui.rs:90-469,
exercised without a display or audio device).

The tkinter view (glc/ui.py) is a thin shell over CodecController;
everything the reference GUI does — async encode with progress, playlist
management, gapless playback with a stop flag, the album FLAC export —
is tested here through the controller API with a mock sink.
"""

import numpy as np
import pytest

from utils import generate_sine_wave

from glc import Encoder, save_encoded
from glc.controller import CodecController
from glc.io.wav import write_wav


class MockSink:
    def __init__(self, sample_rate, channels, log):
        self.sample_rate = sample_rate
        self.channels = channels
        self.parts = []
        self.closed = False
        log.append(self)

    def write(self, samples):
        self.parts.append(np.asarray(samples, np.float32))
        return True

    def append(self, source):
        return self.write(source.remaining())

    def close(self):
        self.closed = True
        return 0


@pytest.fixture()
def wav_file(tmp_path):
    s = generate_sine_wave(440.0, 44100, 1, 0.5)
    p = tmp_path / "tone.wav"
    write_wav(p, s, 44100, 1)
    return p


@pytest.fixture()
def glc_files(tmp_path):
    paths = []
    for i, freq in enumerate((440.0, 660.0)):
        s = generate_sine_wave(freq, 44100, 1, 0.3)
        ea = Encoder(44100).encode(s, 1)
        p = tmp_path / f"t{i}.glc"
        save_encoded(ea, p)
        paths.append(p)
    return paths


def test_file_and_playlist_management(glc_files):
    ctl = CodecController()
    ctl.add_files(["a.wav", "a.wav", "b.wav"])  # dedup (ui.rs file picker)
    assert [p.name for p in ctl.selected_files] == ["a.wav", "b.wav"]

    ctl.encoded_files = list(glc_files)
    ctl.add_to_playlist([1, 0, 7])  # out-of-range index ignored
    assert [p.name for p in ctl.playlist] == ["t1.glc", "t0.glc"]
    ctl.clear_playlist()
    assert ctl.playlist == []

    snap = ctl.snapshot()
    assert snap.status == "Ready"
    assert snap.playing is False
    assert snap.encode_progress is None


def test_encode_selected_produces_glc(wav_file):
    ctl = CodecController()
    ctl.add_files([wav_file])
    ctl.encode_selected(wait=True)
    snap = ctl.snapshot()
    assert snap.status == "Encoded 1/1"
    out = wav_file.with_suffix(".glc")
    assert out.exists()
    assert snap.encoded_files == [out]
    assert snap.encode_progress is None  # progress bar cleared


def test_encode_selected_continue_on_error(tmp_path, wav_file):
    bad = tmp_path / "missing.wav"
    ctl = CodecController()
    ctl.add_files([bad, wav_file])
    ctl.encode_selected(wait=True)
    snap = ctl.snapshot()
    # the bad file errored, the good one still encoded (ui.rs:90-156 /
    # CLI continue-on-error semantics)
    assert snap.status == "Encoded 2/2"
    assert wav_file.with_suffix(".glc").exists()


def test_encode_nothing_selected():
    ctl = CodecController()
    assert ctl.encode_selected() is None
    assert ctl.snapshot().status == "No files selected"


def test_play_gapless_mock_sink(glc_files):
    log = []
    ctl = CodecController(sink_factory=lambda r, c: MockSink(r, c, log))
    ctl.encoded_files = list(glc_files)
    ctl.add_to_playlist([0, 1])
    ctl.play_gapless(wait=True)
    snap = ctl.snapshot()
    assert snap.status == "Playback finished"
    assert snap.playing is False
    assert len(log) == 1  # same format → one sink across the boundary
    assert log[0].closed
    total = sum(len(p) for p in log[0].parts)
    assert total > 0


def test_play_gapless_empty_playlist():
    ctl = CodecController()
    assert ctl.play_gapless() is None


def test_play_gapless_stop_flag(glc_files):
    """The stop flag is honored between chunks (ui.rs stop-flag-per-chunk,
    ui.rs:224-271): a stop raised after the first chunk ends playback before
    the second file streams."""
    log = []
    ctl = CodecController()

    class StoppingSink(MockSink):
        def append(self, source):
            ok = super().append(source)
            ctl.stop_playing()  # raise stop from the consumer side
            return ok

    ctl._sink_factory = lambda r, c: StoppingSink(r, c, log)
    ctl.encoded_files = list(glc_files)
    ctl.add_to_playlist([0, 1])
    ctl.play_gapless(wait=True)
    # exactly one chunk was written before the stop took effect
    total_parts = sum(len(s.parts) for s in log)
    assert total_parts == 1
    assert ctl.snapshot().playing is False
    assert all(s.closed for s in log)


def test_export_playlist_flac(glc_files, tmp_path):
    ctl = CodecController()
    ctl.encoded_files = list(glc_files)
    ctl.add_to_playlist([0, 1])
    out = tmp_path / "album.flac"
    ctl.export_playlist(out, compression_level=3, wait=True)
    snap = ctl.snapshot()
    assert snap.status == "Export complete"
    assert out.exists() and out.stat().st_size > 0
    assert snap.export_progress is None

    # the exported album must be the gapless concatenation of both decodes
    from glc.flac.decoder import read_flac

    samples, rate, ch = read_flac(out)
    assert rate == 44100 and ch == 1
    expected = int(44100 * 0.3) * 2
    assert len(samples) == expected


def test_export_empty_playlist():
    ctl = CodecController()
    assert ctl.export_playlist("/tmp/x.flac") is None
    assert ctl.snapshot().status == "Playlist is empty"


def test_ui_imports_and_uses_controller():
    """ui.py must import cleanly and be a view over CodecController."""
    import glc.ui

    assert hasattr(glc.ui, "run_gui")
    import inspect

    src = inspect.getsource(glc.ui)
    assert "CodecController" in src
