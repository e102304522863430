"""Regression tests for round-2 self-review findings (see git history):
ragged-stream FLAC export, short-track sharded album encode, oversized
duplicate pair rows in hostile containers, and GUI error-status retention.
"""

import numpy as np
import pytest

from utils import generate_sine_wave

from glc import Decoder, Encoder
from glc.container.schema import (
    PAIR_DTYPE,
    AudioHeader,
    EncodedAudio,
    FrameSet,
    GaplessInfo,
)
from glc.flac.encoder import (
    encode_flac_i16_streaming,
    encode_flac_i16_with_level,
)


def test_streaming_flac_ragged_interleaved_stream():
    """A stream whose length is not a multiple of channels (frame_signal
    accepts ragged interleaved input on encode) must export like the batch
    path, which silently drops the fractional trailing sample."""
    rng = np.random.default_rng(3)
    i16 = (rng.standard_normal(44100 + 1) * 6000).astype(np.int16)  # odd, C=2
    ref = encode_flac_i16_with_level(i16, 44100, 2, 5)
    got = encode_flac_i16_streaming(iter([i16[:30000], i16[30000:]]),
                                    44100, 2, 5, len(i16) // 2)
    assert got == ref


def test_ragged_glc_decode_to_flac_end_to_end(tmp_path):
    """Encode ragged stereo → .glc → CLI FLAC export (streaming path)."""
    from glc import save_encoded
    from glc.cli import main

    s = generate_sine_wave(440.0, 44100, 2, 0.5)[:-1]  # odd interleaved count
    ea = Encoder(44100).encode(s, 2)
    p = tmp_path / "ragged.glc"
    save_encoded(ea, p)
    assert main(["-d", str(p)]) == 0
    out = tmp_path / "ragged.flac"
    assert out.exists() and out.stat().st_size > 0


def test_album_sharded_short_track():
    """Tracks shorter than one frame must encode on the mesh exactly like
    the serial encoder (which zero-extends its resident signal)."""
    from glc import serialize_encoded
    from glc.parallel import encode_album_sharded, make_mesh

    mesh = make_mesh(8)
    short = generate_sine_wave(440.0, 44100, 2, 0.002)  # ~88 samples/channel
    normal = generate_sine_wave(660.0, 44100, 2, 0.3)
    sharded = encode_album_sharded(mesh, [normal, short], 2, 44100)
    enc = Encoder(44100)
    for s, ea in zip([normal, short], sharded):
        assert serialize_encoded(ea) == serialize_encoded(enc.encode(s, 2))


def test_decode_hostile_container_with_huge_duplicate_row():
    """A (wire-legal) container declaring 70000 pairs in one frame-channel
    — necessarily full of duplicates — must decode with the reference's
    last-wins semantics, not wrap the device's uint16 nnz section."""
    n = 1024
    F, C = 3, 1
    rng = np.random.default_rng(0)
    big = 70000
    nnz = np.zeros((F, C), np.int64)
    nnz[1, 0] = big
    nnz[2, 0] = 4
    pairs = np.zeros(big + 4, PAIR_DTYPE)
    # row 1: the same few positions repeated; LAST occurrence must win
    ks = rng.integers(0, 8, big).astype(np.uint16)
    pairs["k"][:big] = ks
    pairs["q"][:big] = rng.integers(-3000, 3000, big).astype(np.int16)
    # make the final occurrence of k=5 a known value
    pairs["k"][big - 1] = 5
    pairs["q"][big - 1] = 1234
    # row 2: a well-formed run
    pairs["k"][big:] = [1, 2, 3, 4]
    pairs["q"][big:] = [100, -100, 50, -50]

    fs = FrameSet(nnz, pairs, np.ones((F, C), np.float32),
                  np.zeros(F, bool), np.empty((0, 2048), np.int16))
    ea = EncodedAudio(
        header=AudioHeader(44100, 1, 4096),
        frame_set=fs,
        gapless_info=GaplessInfo(512, 0, 4096),
    )
    out = Decoder(1, 44100).decode(ea)
    assert len(out) == 3584  # (F+1)*n pre-trim minus the 512 encoder delay
    assert np.isfinite(out).all()

    # oracle: the same container with row 1 pre-deduplicated (last-wins)
    last = {}
    for k, q in zip(pairs["k"][:big], pairs["q"][:big]):
        last[int(k)] = int(q)
    dk = np.array(sorted(last), np.uint16)
    dq = np.array([last[int(k)] for k in dk], np.int16)
    nnz2 = nnz.copy()
    nnz2[1, 0] = len(dk)
    pairs2 = np.zeros(len(dk) + 4, PAIR_DTYPE)
    pairs2["k"][: len(dk)] = dk
    pairs2["q"][: len(dk)] = dq
    pairs2["k"][len(dk):] = [1, 2, 3, 4]
    pairs2["q"][len(dk):] = [100, -100, 50, -50]
    fs2 = FrameSet(nnz2, pairs2, np.ones((F, C), np.float32),
                   np.zeros(F, bool), np.empty((0, 2048), np.int16))
    ea2 = EncodedAudio(header=ea.header, frame_set=fs2,
                       gapless_info=ea.gapless_info)
    np.testing.assert_array_equal(out, Decoder(1, 44100).decode(ea2))
    assert last[5] == 1234  # the construction really tested last-wins


def test_controller_decode_error_status_survives(tmp_path):
    """A decode error during GUI playback must remain visible — not be
    overwritten by 'Playback finished' (old view-thread returned early)."""
    from glc import save_encoded
    from glc.controller import CodecController

    good = tmp_path / "good.glc"
    save_encoded(
        Encoder(44100).encode(generate_sine_wave(440.0, 44100, 1, 0.2), 1),
        good,
    )

    class NullSink:
        def __init__(self, *a):
            pass

        def append(self, source):
            return True

        def close(self):
            return 0

    ctl = CodecController(sink_factory=lambda r, c: NullSink())
    ctl.encoded_files = [good]
    ctl.add_to_playlist([0])

    # force a decode error by monkeypatching the chunk stream
    import glc.playback as pb

    real = pb.stream_playlist_sources

    def failing(paths, stop=None, on_file=None, on_error=None):
        for path in paths:
            if on_file is not None:
                on_file(path, 44100, 1)
            if on_error is not None:
                on_error(path, "synthetic decode failure")
        return iter(())

    pb.stream_playlist_sources = failing
    try:
        ctl.play_gapless(wait=True)
    finally:
        pb.stream_playlist_sources = real
    snap = ctl.snapshot()
    assert snap.status == "Decode error"
    assert snap.detail == "synthetic decode failure"
    assert snap.playing is False
