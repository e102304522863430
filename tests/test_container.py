"""Container round-trip tests + hand-computed bincode v1 byte vectors.

The wire format must byte-match Rust `bincode::serialize` of the reference's
serde structs (reference src/codec.rs:31-69, 774-786; SURVEY.md Q9).  The
golden vectors here are constructed by hand from the bincode v1 spec
(little-endian, fixint, u64 Vec lengths, 1-byte Option tag).
"""

import struct

import numpy as np
import pytest

from glc.container.schema import (
    PAIR_DTYPE,
    AudioHeader,
    EncodedAudio,
    EncodedFrame,
    FrameSet,
    GaplessInfo,
)
from glc.container.bincode import (
    BincodeError,
    deserialize_encoded,
    serialize_encoded,
)


def make_pairs(items):
    arr = np.empty(len(items), PAIR_DTYPE)
    for i, (k, q) in enumerate(items):
        arr[i] = (k, q)
    return arr


def test_golden_bytes_compressed_frame():
    """One mono compressed frame with two coefficients — exact bytes."""
    frame = EncodedFrame(
        sparse_coeffs_per_channel=[make_pairs([(3, -7), (100, 1234)])],
        scale_factors=np.array([0.5], np.float32),
    )
    enc = EncodedAudio.from_frames(
        AudioHeader(44100, 1, 1000),
        [frame],
        GaplessInfo(512, 72, 1000),
    )
    got = serialize_encoded(enc)

    expected = b"".join([
        struct.pack("<IHQ", 44100, 1, 1000),      # AudioHeader
        struct.pack("<Q", 1),                      # frames vec len
        struct.pack("<Q", 1),                      # sparse outer vec len (1 ch)
        struct.pack("<Q", 2),                      # channel 0: 2 pairs
        struct.pack("<Hh", 3, -7),
        struct.pack("<Hh", 100, 1234),
        struct.pack("<Q", 1),                      # scale_factors len
        struct.pack("<f", 0.5),
        b"\x00",                                   # Option::None
        struct.pack("<IIQ", 512, 72, 1000),        # GaplessInfo
    ])
    assert got == expected


def test_golden_bytes_raw_frame():
    """One stereo raw-PCM frame — exact bytes (frame_size=2 for brevity)."""
    raw = np.array([10, -20, 30, -40], np.int16)  # frame_size*C = 2*2
    frame = EncodedFrame(raw_pcm=raw)
    enc = EncodedAudio.from_frames(
        AudioHeader(48000, 2, 8),
        [frame],
        GaplessInfo(512, 0, 8),
        frame_size=2,
    )
    got = serialize_encoded(enc)

    expected = b"".join([
        struct.pack("<IHQ", 48000, 2, 8),
        struct.pack("<Q", 1),           # frames
        struct.pack("<Q", 0),           # empty sparse outer vec
        struct.pack("<Q", 0),           # empty scale_factors
        b"\x01",                        # Option::Some
        struct.pack("<Q", 4),           # raw vec len
        struct.pack("<4h", 10, -20, 30, -40),
        struct.pack("<IIQ", 512, 0, 8),
    ])
    assert got == expected


def test_round_trip_mixed_frames():
    rng = np.random.default_rng(0)
    C = 2
    frames = []
    for fi in range(57):
        if fi % 5 == 3:
            frames.append(
                EncodedFrame(
                    raw_pcm=rng.integers(-32768, 32767, 2048 * C).astype(np.int16)
                )
            )
        else:
            per_ch = []
            for c in range(C):
                nnz = int(rng.integers(0, 40))
                ks = np.sort(
                    rng.choice(1024, size=nnz, replace=False).astype(np.uint16)
                )
                qs = rng.integers(-32768, 32767, nnz).astype(np.int16)
                qs[qs == 0] = 1
                per_ch.append(make_pairs(list(zip(ks.tolist(), qs.tolist()))))
            frames.append(
                EncodedFrame(
                    sparse_coeffs_per_channel=per_ch,
                    scale_factors=rng.random(C).astype(np.float32),
                )
            )
    enc = EncodedAudio.from_frames(
        AudioHeader(44100, C, 123456), frames, GaplessInfo(512, 100, 123456)
    )
    data = serialize_encoded(enc)
    dec = deserialize_encoded(data)

    assert dec.header.sample_rate == 44100
    assert dec.header.channels == C
    assert dec.header.total_samples == 123456
    assert dec.gapless_info.encoder_delay == 512
    assert dec.gapless_info.padding == 100
    assert len(dec.frames) == 57
    for orig, got in zip(frames, dec.frames):
        assert orig.is_raw == got.is_raw
        if orig.is_raw:
            np.testing.assert_array_equal(orig.raw_pcm, got.raw_pcm)
        else:
            np.testing.assert_array_equal(orig.scale_factors, got.scale_factors)
            for a, b in zip(orig.sparse_coeffs_per_channel,
                            got.sparse_coeffs_per_channel):
                np.testing.assert_array_equal(a, b)
    # Re-serialization is byte-identical
    assert serialize_encoded(dec) == data


def test_empty_frames():
    enc = EncodedAudio(
        AudioHeader(44100, 1, 0),
        FrameSet.empty(1),
        GaplessInfo(512, 0, 0),
    )
    data = serialize_encoded(enc)
    dec = deserialize_encoded(data)
    assert len(dec.frames) == 0
    assert serialize_encoded(dec) == data


def test_truncated_data_raises():
    enc = EncodedAudio.from_frames(
        AudioHeader(44100, 1, 10),
        [EncodedFrame(
            sparse_coeffs_per_channel=[make_pairs([(1, 2)])],
            scale_factors=np.array([1.0], np.float32),
        )],
        GaplessInfo(512, 0, 10),
    )
    data = serialize_encoded(enc)
    for cut in (5, 20, len(data) - 1):
        with pytest.raises(BincodeError):
            deserialize_encoded(data[:cut])


def test_zero_nnz_channel():
    """A compressed frame may legitimately have zero kept coefficients."""
    frame = EncodedFrame(
        sparse_coeffs_per_channel=[np.empty(0, PAIR_DTYPE)],
        scale_factors=np.array([1e-10], np.float32),
    )
    enc = EncodedAudio.from_frames(
        AudioHeader(44100, 1, 100), [frame], GaplessInfo(512, 0, 100)
    )
    dec = deserialize_encoded(serialize_encoded(enc))
    assert len(dec.frames[0].sparse_coeffs_per_channel[0]) == 0


def test_native_and_numpy_paths_byte_identical():
    """The native C++ writer/parser and the numpy fallback must agree."""
    from glc.container import bincode as bc
    from glc.native import get_native

    assert get_native() is not None
    rng = np.random.default_rng(7)
    C = 2
    frames = []
    for fi in range(23):
        if fi % 4 == 1:
            frames.append(EncodedFrame(
                raw_pcm=rng.integers(-32768, 32767, 2048 * C).astype(np.int16)
            ))
        else:
            per_ch = []
            for _ in range(C):
                nnz = int(rng.integers(0, 30))
                ks = np.sort(rng.choice(1024, nnz, replace=False)).astype(np.uint16)
                qs = rng.integers(1, 3000, nnz).astype(np.int16)
                per_ch.append(make_pairs(list(zip(ks.tolist(), qs.tolist()))))
            frames.append(EncodedFrame(
                sparse_coeffs_per_channel=per_ch,
                scale_factors=rng.random(C).astype(np.float32),
            ))
    enc = EncodedAudio.from_frames(
        AudioHeader(48000, C, 999), frames, GaplessInfo(512, 1, 999)
    )
    native_bytes = bc._native_serialize(enc)
    numpy_bytes = bc._serialize_encoded_numpy(enc)
    assert native_bytes == numpy_bytes

    a = bc._native_deserialize(native_bytes)
    b = bc._deserialize_encoded_numpy(native_bytes)
    assert bc._serialize_encoded_numpy(a) == bc._serialize_encoded_numpy(b)


def test_trailing_bytes_tolerated():
    """bincode v1's legacy deserialize allows trailing bytes after the
    payload (codec.rs:781-786); both parsers must too."""
    from glc.container import bincode as bc

    enc = EncodedAudio.from_frames(
        AudioHeader(44100, 1, 10),
        [EncodedFrame(
            sparse_coeffs_per_channel=[make_pairs([(1, 2)])],
            scale_factors=np.array([1.0], np.float32),
        )],
        GaplessInfo(512, 0, 10),
    )
    data = serialize_encoded(enc) + b"\x00trailing-junk"
    for parse in (bc._native_deserialize, bc._deserialize_encoded_numpy):
        dec = parse(data)
        assert dec.gapless_info.encoder_delay == 512
        assert len(dec.frames) == 1


def test_negative_index_out_of_range_raises():
    enc = EncodedAudio.from_frames(
        AudioHeader(44100, 1, 10),
        [EncodedFrame(
            sparse_coeffs_per_channel=[make_pairs([(1, 2)])],
            scale_factors=np.array([1.0], np.float32),
        )],
        GaplessInfo(512, 0, 10),
    )
    assert enc.frames[-1].scale_factors[0] == 1.0
    with pytest.raises(IndexError):
        enc.frames[-2]
    with pytest.raises(IndexError):
        enc.frames[1]


# ---------------------------------------------------------------------------
# Adversarial golden corpus: exact expected bytes for the
# shapes a subtly wrong writer could mis-serialize while passing round-trip
# and fuzz tests.  Every `expected` below is assembled with struct/numpy
# little-endian packing straight from the bincode v1 wire rules (LE fixint,
# u64 Vec lengths, 1-byte Option tag, fields in declaration order —
# reference src/codec.rs:31-69, 774-786; SURVEY.md Q9), independently of the
# writer under test.  Both writer paths (native C++ and numpy) must match.
# ---------------------------------------------------------------------------


def _both_writers(enc):
    from glc.container import bincode as bc
    from glc.native import get_native

    outs = [("numpy", bc._serialize_encoded_numpy(enc))]
    if get_native() is not None:
        outs.append(("native", bc._native_serialize(enc)))
    return outs


def test_golden_bytes_zero_frames():
    """F=0: just header + empty vec + gapless info (the smallest legal
    container, 38 bytes)."""
    enc = EncodedAudio(
        AudioHeader(96000, 2, 0), FrameSet.empty(2), GaplessInfo(512, 0, 0)
    )
    expected = (
        struct.pack("<IHQ", 96000, 2, 0)
        + struct.pack("<Q", 0)
        + struct.pack("<IIQ", 512, 0, 0)
    )
    assert len(expected) == 38
    for name, got in _both_writers(enc):
        assert got == expected, name
    rt = deserialize_encoded(expected)
    assert rt.header.sample_rate == 96000
    assert len(rt.frames) == 0


def test_golden_bytes_max_nnz_frame():
    """A frame with all n=1024 coefficients kept in both channels — the
    maximum pairs-per-channel a well-formed stream can carry."""
    n = 1024
    ks = np.arange(n, dtype=np.uint16)
    qs = np.where(ks % 2 == 0, 1, -1).astype(np.int16)
    per_ch = [make_pairs(list(zip(ks.tolist(), qs.tolist())))] * 2
    frame = EncodedFrame(
        sparse_coeffs_per_channel=per_ch,
        scale_factors=np.array([1.5, -0.0], np.float32),
    )
    enc = EncodedAudio.from_frames(
        AudioHeader(44100, 2, 2048), [frame], GaplessInfo(512, 0, 2048)
    )
    pair_bytes = np.empty(n, dtype=[("k", "<u2"), ("q", "<i2")])
    pair_bytes["k"] = ks
    pair_bytes["q"] = qs
    ch_bytes = struct.pack("<Q", n) + pair_bytes.tobytes()
    expected = b"".join([
        struct.pack("<IHQ", 44100, 2, 2048),
        struct.pack("<Q", 1),
        struct.pack("<Q", 2),
        ch_bytes, ch_bytes,
        struct.pack("<Q", 2),
        struct.pack("<ff", 1.5, -0.0),   # -0.0 keeps its sign bit on the wire
        b"\x00",
        struct.pack("<IIQ", 512, 0, 2048),
    ])
    for name, got in _both_writers(enc):
        assert got == expected, name
    # -0.0's sign bit survives the round trip bit-exactly
    rt = deserialize_encoded(expected)
    assert np.signbit(rt.frames[0].scale_factors[1])


def test_golden_bytes_beyond_u16_frame_count():
    """70,000 frames (> 2^16): the frames-vec length is a u64 and per-frame
    records must not be truncated by any 16-bit index arithmetic."""
    F = 70_000
    nnz = np.zeros((F, 1), np.int64)
    pairs = np.empty(0, PAIR_DTYPE)
    scales = np.full((F, 1), 0.25, np.float32)
    raw_mask = np.zeros(F, bool)
    fs = FrameSet(nnz, pairs, scales, raw_mask,
                  np.empty((0, 2048), np.int16), 2048)
    enc = EncodedAudio(
        AudioHeader(44100, 1, 2 ** 33), fs, GaplessInfo(512, 7, 2 ** 33)
    )
    frame_rec = (
        struct.pack("<Q", 1)          # outer vec: 1 channel
        + struct.pack("<Q", 0)        # 0 pairs
        + struct.pack("<Q", 1)        # 1 scale factor
        + struct.pack("<f", 0.25)
        + b"\x00"                     # Option::None
    )
    expected = (
        struct.pack("<IHQ", 44100, 1, 2 ** 33)
        + struct.pack("<Q", F)
        + frame_rec * F
        + struct.pack("<IIQ", 512, 7, 2 ** 33)
    )
    for name, got in _both_writers(enc):
        assert got == expected, name
    rt = deserialize_encoded(expected)
    assert rt.frame_set.num_frames == F
    assert rt.header.total_samples == 2 ** 33  # u64, not truncated to u32


def test_golden_bytes_mixed_raw_compressed_run():
    """Alternating raw / compressed frames: the Option tag and the two
    frame layouts must interleave exactly, with raw rows in frame order."""
    C = 2
    fsz = 4  # small frame_size keeps the literal readable
    raws = [
        np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int16),
        np.array([-1, -2, -3, -4, -5, -6, -7, -8], np.int16),
    ]
    comp_pairs = make_pairs([(0, 100)])
    frames = [
        EncodedFrame(raw_pcm=raws[0]),
        EncodedFrame(sparse_coeffs_per_channel=[comp_pairs, comp_pairs[:0]],
                     scale_factors=np.array([2.0, 3.0], np.float32)),
        EncodedFrame(raw_pcm=raws[1]),
    ]
    enc = EncodedAudio.from_frames(
        AudioHeader(8000, C, 24), frames, GaplessInfo(512, 0, 24),
        frame_size=fsz,
    )
    raw_rec = lambda r: (
        struct.pack("<Q", 0)              # empty sparse outer vec
        + struct.pack("<Q", 0)            # empty scale_factors
        + b"\x01"                         # Option::Some
        + struct.pack("<Q", C * fsz)
        + r.astype("<i2").tobytes()
    )
    comp_rec = (
        struct.pack("<Q", 2)
        + struct.pack("<Q", 1) + struct.pack("<Hh", 0, 100)
        + struct.pack("<Q", 0)            # channel 1: zero pairs
        + struct.pack("<Q", 2) + struct.pack("<ff", 2.0, 3.0)
        + b"\x00"
    )
    expected = (
        struct.pack("<IHQ", 8000, C, 24)
        + struct.pack("<Q", 3)
        + raw_rec(raws[0]) + comp_rec + raw_rec(raws[1])
        + struct.pack("<IIQ", 512, 0, 24)
    )
    for name, got in _both_writers(enc):
        assert got == expected, name
    rt = deserialize_encoded(expected)
    assert [f.is_raw for f in rt.frames] == [True, False, True]
    np.testing.assert_array_equal(rt.frames[2].raw_pcm, raws[1])


def test_frameset_dense_q():
    """dense_q scatters each (frame, channel) row's pairs at their k; raw
    frames and out-of-range indices stay 0, and the last duplicate wins."""
    n = 4
    nnz = np.array([[2, 1], [0, 0], [3, 0]], np.int64)
    pairs = make_pairs([(0, 5), (3, -2), (1, 7), (2, 1), (2, 9), (n, 4)])
    raw = np.zeros((1, 2 * n * 2), np.int16)
    fs = FrameSet(nnz, pairs, np.ones((3, 2), np.float32),
                  np.array([False, True, False]), raw, frame_size=2 * n)
    want = np.zeros((3, 2, n), np.int32)
    want[0, 0, 0], want[0, 0, 3], want[0, 1, 1] = 5, -2, 7
    want[2, 0, 2] = 9
    assert np.array_equal(fs.dense_q(), want)
