"""Deterministic fuzz of the native parsers: mutated and random buffers must
produce clean errors, never crashes or hangs (the C++ scan passes are fully
bounds-checked)."""

import numpy as np
import pytest

from glc import Encoder, serialize_encoded
from glc.container.bincode import BincodeError, deserialize_encoded
from glc.flac import decode_flac, encode_flac
from glc.flac.decoder import FlacDecodeError
from utils import generate_sine_wave


@pytest.fixture(scope="module")
def glc_bytes():
    samples = generate_sine_wave(440.0, 44100, 2, 0.5)
    return serialize_encoded(Encoder(44100).encode(samples, 2))


@pytest.fixture(scope="module")
def flac_bytes():
    samples = generate_sine_wave(440.0, 44100, 1, 0.5)
    return encode_flac(samples, 44100, 1)


def test_glc_random_buffers():
    rng = np.random.default_rng(0)
    for n in (0, 1, 13, 37, 100, 4096):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        with pytest.raises(BincodeError):
            deserialize_encoded(data)


def test_glc_truncations(glc_bytes):
    rng = np.random.default_rng(1)
    cuts = rng.integers(1, len(glc_bytes), 50)
    survived = 0
    for cut in cuts:
        try:
            deserialize_encoded(glc_bytes[: int(cut)])
            survived += 1  # a prefix can rarely still parse cleanly
        except BincodeError:
            pass
    # truncation must essentially always be detected
    assert survived <= 1


def test_glc_byte_flips(glc_bytes):
    """Flipped bytes either error or parse to *something* — never crash.
    (bincode has no checksums, so some flips produce valid-but-different
    containers, exactly like the reference.)"""
    rng = np.random.default_rng(2)
    for _ in range(60):
        buf = bytearray(glc_bytes)
        i = int(rng.integers(0, len(buf)))
        buf[i] ^= int(rng.integers(1, 256))
        try:
            deserialize_encoded(bytes(buf))
        except BincodeError:
            pass


def test_flac_random_buffers():
    rng = np.random.default_rng(3)
    for n in (0, 3, 4, 42, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        with pytest.raises(FlacDecodeError):
            decode_flac(data)


def test_flac_byte_flips(flac_bytes):
    """CRC-8/16 verification catches essentially all frame corruption."""
    rng = np.random.default_rng(4)
    silent = 0
    for _ in range(60):
        buf = bytearray(flac_bytes)
        i = int(rng.integers(42, len(buf)))  # past fLaC+STREAMINFO
        buf[i] ^= int(rng.integers(1, 256))
        try:
            decode_flac(bytes(buf))
            silent += 1
        except FlacDecodeError:
            pass
    assert silent <= 2


def test_flac_truncations(flac_bytes):
    rng = np.random.default_rng(5)
    for cut in rng.integers(4, len(flac_bytes), 40):
        try:
            decode_flac(flac_bytes[: int(cut)])
        except FlacDecodeError:
            pass


def test_flac_hostile_streaminfo_no_abort():
    """A crafted STREAMINFO claiming 2^36-1 samples × 8 channels must not
    abort the process via bad_alloc (exceptions stay behind the C ABI)."""
    from glc.flac.bitpack import BitWriter
    w = BitWriter()
    w.write_bytes(b"fLaC")
    w.write_bits(1, 1); w.write_bits(0, 7); w.write_bits(34, 24)
    w.write_bits(16, 16); w.write_bits(16, 16)
    w.write_bits(0, 24); w.write_bits(0, 24)
    w.write_bits(44100, 20); w.write_bits(7, 3); w.write_bits(15, 5)
    w.write_bits((1 << 36) - 1, 36)
    w.write_bytes(b"\x00" * 16)
    data = w.get_bytes()
    # decodes to zero frames (no frame data) or errors — must not crash
    try:
        out, r, c, b = decode_flac(data)
        assert len(out) == 0
    except FlacDecodeError:
        pass


def test_encode_nan_inf_input_no_crash():
    """NaN/Inf samples are garbage-in (the reference propagates them into
    quantization too), but the pipeline must not crash and the container
    must stay structurally valid and round-trippable."""
    from glc import Decoder

    s = generate_sine_wave(440.0, 44100, 1, 0.2)
    s[100] = np.nan
    s[200] = np.inf
    s[300] = -np.inf
    ea = Encoder(44100).encode(s, 1)
    fs = ea.frame_set
    assert len(fs.pairs) == int(fs.nnz.sum())
    data = serialize_encoded(ea)
    out = Decoder(1, 44100).decode(deserialize_encoded(data))
    assert len(out) == len(s)  # length contract survives hostile samples


def test_glc_huge_count_overflow_rejected(glc_bytes):
    """A nnz count near 2^62 must fail validation, not wrap the bounds
    check (signed-overflow UB) and crash the parser."""
    buf = bytearray(glc_bytes)
    # first frame's channel-0 count field sits at offset 22+8
    import struct
    struct.pack_into("<Q", buf, 30, (1 << 62) + 10)
    with pytest.raises(BincodeError):
        deserialize_encoded(bytes(buf))
