"""Property-based cross-writer container fuzz.

The .glc container has TWO independent writers (the native C++ single-pass
serializer and the vectorized numpy writer) and TWO independent parsers.
Random FrameSets round-tripped through every writer×parser combination must
agree byte-for-byte and field-for-field — the strongest bit-identity
evidence available without the reference binary (reference
src/codec.rs:774-786, bincode-v1 wire format, quirk Q9).
"""

import numpy as np
import pytest

from glc.container.bincode import (
    _deserialize_encoded_numpy,
    _native_deserialize,
    _native_serialize,
    _serialize_encoded_numpy,
    deserialize_encoded,
    serialize_encoded,
)
from glc.container.schema import (
    PAIR_DTYPE,
    AudioHeader,
    EncodedAudio,
    FrameSet,
    GaplessInfo,
)
from glc.native import get_native

NATIVE = get_native() is not None


def random_encoded(rng: np.random.Generator) -> EncodedAudio:
    """A random but structurally valid EncodedAudio."""
    F = int(rng.integers(1, 40))
    C = int(rng.integers(1, 4))
    frame_size = 2048
    n = frame_size // 2

    raw_mask = rng.random(F) < 0.25
    nnz = rng.integers(0, 60, (F, C)).astype(np.int64)
    nnz[raw_mask] = 0

    K = int(nnz.sum())
    pairs = np.empty(K, PAIR_DTYPE)
    # ascending k within each (frame, channel) run, like real streams
    off = 0
    for f in range(F):
        for c in range(C):
            m = int(nnz[f, c])
            if m:
                ks = np.sort(rng.choice(n, size=m, replace=False))
                pairs["k"][off : off + m] = ks.astype(np.uint16)
                off += m
    pairs["q"] = rng.integers(-32768, 32768, K).astype(np.int16)

    scales = rng.random((F, C)).astype(np.float32) + np.float32(1e-3)
    # raw frames carry EMPTY scale/pair vecs on the wire (reference
    # src/codec.rs:524-530), so a parse round-trip yields 0.0 there —
    # generate what the wire can represent
    scales[raw_mask] = 0.0
    R = int(raw_mask.sum())
    raw_pcm = rng.integers(-32768, 32768, (R, frame_size * C)).astype(np.int16)

    rate = int(rng.choice([8000, 44100, 48000, 96000]))
    total = int(rng.integers(0, 1 << 40))
    return EncodedAudio(
        header=AudioHeader(rate, C, total),
        frame_set=FrameSet(nnz, pairs, scales, raw_mask, raw_pcm, frame_size),
        gapless_info=GaplessInfo(
            encoder_delay=int(rng.integers(0, 1 << 16)),
            padding=int(rng.integers(0, 1 << 16)),
            original_length=total,
        ),
    )


def assert_equal_encoded(a: EncodedAudio, b: EncodedAudio) -> None:
    assert a.header.sample_rate == b.header.sample_rate
    assert a.header.channels == b.header.channels
    assert a.header.total_samples == b.header.total_samples
    assert a.gapless_info.encoder_delay == b.gapless_info.encoder_delay
    assert a.gapless_info.padding == b.gapless_info.padding
    assert a.gapless_info.original_length == b.gapless_info.original_length
    fa, fb = a.frame_set, b.frame_set
    np.testing.assert_array_equal(fa.nnz, fb.nnz)
    np.testing.assert_array_equal(fa.pairs, fb.pairs)
    np.testing.assert_array_equal(fa.scales, fb.scales)
    np.testing.assert_array_equal(fa.raw_mask, fb.raw_mask)
    np.testing.assert_array_equal(fa.raw_pcm, fb.raw_pcm)


@pytest.mark.skipif(not NATIVE, reason="native library unavailable")
def test_cross_writer_byte_identity():
    """native-serialize == numpy-serialize, byte for byte, over 40 random
    FrameSets (pairs, scales, raw frames, multi-channel, zero-nnz rows)."""
    rng = np.random.default_rng(42)
    for _ in range(40):
        ea = random_encoded(rng)
        nat = _native_serialize(ea)
        npy = _serialize_encoded_numpy(ea)
        assert nat is not None
        assert nat == npy


@pytest.mark.skipif(not NATIVE, reason="native library unavailable")
def test_cross_parser_field_identity():
    """native-parse(numpy-serialize) and numpy-parse(native-serialize) both
    reproduce the original fields exactly."""
    rng = np.random.default_rng(43)
    for _ in range(25):
        ea = random_encoded(rng)
        nat_bytes = _native_serialize(ea)
        npy_bytes = _serialize_encoded_numpy(ea)

        via_native = _native_deserialize(npy_bytes)
        via_numpy = _deserialize_encoded_numpy(nat_bytes)
        assert via_native is not None
        assert_equal_encoded(via_native, ea)
        assert_equal_encoded(via_numpy, ea)


def test_roundtrip_default_path():
    """The public serialize→deserialize pair is the identity on random
    containers regardless of which implementation backs it."""
    rng = np.random.default_rng(44)
    for _ in range(15):
        ea = random_encoded(rng)
        data = serialize_encoded(ea)
        back = deserialize_encoded(data)
        assert_equal_encoded(back, ea)
        # serialization of the parsed form is byte-stable
        assert serialize_encoded(back) == data


def test_empty_and_edge_shapes():
    """Degenerate containers: zero pairs everywhere, all-raw, single frame."""
    rng = np.random.default_rng(45)
    # all-sparse-empty (silence-like)
    F, C = 3, 2
    ea = EncodedAudio(
        header=AudioHeader(44100, C, 0),
        frame_set=FrameSet(
            np.zeros((F, C), np.int64), np.empty(0, PAIR_DTYPE),
            np.ones((F, C), np.float32), np.zeros(F, bool),
            np.empty((0, 2048 * C), np.int16),
        ),
        gapless_info=GaplessInfo(512, 0, 0),
    )
    data = serialize_encoded(ea)
    assert_equal_encoded(deserialize_encoded(data), ea)
    if NATIVE:
        assert _serialize_encoded_numpy(ea) == _native_serialize(ea)

    # all-raw (raw frames carry no scales on the wire, codec.rs:524-530)
    raw = rng.integers(-32768, 32768, (F, 2048 * C)).astype(np.int16)
    ea2 = EncodedAudio(
        header=AudioHeader(48000, C, 100),
        frame_set=FrameSet(
            np.zeros((F, C), np.int64), np.empty(0, PAIR_DTYPE),
            np.zeros((F, C), np.float32), np.ones(F, bool), raw,
        ),
        gapless_info=GaplessInfo(512, 12, 100),
    )
    data2 = serialize_encoded(ea2)
    assert_equal_encoded(deserialize_encoded(data2), ea2)
    if NATIVE:
        assert _serialize_encoded_numpy(ea2) == _native_serialize(ea2)
