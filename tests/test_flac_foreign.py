"""Decoder coverage for FLAC features our encoder never emits.

The reference loads arbitrary FLAC files through claxon (audio.rs:66-83), so
our independent decoder must handle the full RFC 9639 subset found in the
wild: constant subframes, LPC, mid/left/right-side stereo decorrelation,
wasted bits, and escape-coded residual partitions.  These streams are
hand-assembled bit-by-bit with the Python BitWriter.
"""

import numpy as np

from glc.flac import decode_flac
from glc.flac.bitpack import BitWriter, crc8, crc16, write_utf8_number

BS = 16  # block size for all hand-built frames
RATE = 44100


def stream_header(w: BitWriter, channels: int, total: int, bps: int = 16):
    w.write_bytes(b"fLaC")
    w.write_bits(1, 1)       # last metadata block
    w.write_bits(0, 7)       # streaminfo
    w.write_bits(34, 24)
    w.write_bits(BS, 16)
    w.write_bits(BS, 16)
    w.write_bits(0, 24)
    w.write_bits(0, 24)
    w.write_bits(RATE, 20)
    w.write_bits(channels - 1, 3)
    w.write_bits(bps - 1, 5)
    w.write_bits(total, 36)
    w.write_bytes(b"\x00" * 16)  # md5 unchecked by the decoder


def frame_header(w: BitWriter, chan_assign: int, frame_no: int = 0):
    start = len(w.buf)
    w.write_bits(0x3FFE, 14)
    w.write_bits(0, 1)
    w.write_bits(0, 1)
    w.write_bits(0b0110, 4)          # 8-bit blocksize-1 follows
    w.write_bits(0b1001, 4)          # 44100
    w.write_bits(chan_assign, 4)
    w.write_bits(0b100, 3)           # 16-bit
    w.write_bits(0, 1)
    write_utf8_number(w, frame_no)
    w.write_byte(BS - 1)
    w.write_byte(crc8(bytes(w.buf[start:])))
    return start


def finish_frame(w: BitWriter, start: int):
    w.byte_align()
    w.write_bits(crc16(bytes(w.buf[start:])), 16)


def verbatim_subframe(w: BitWriter, samples, bps: int):
    w.write_bits(0, 1)
    w.write_bits(0b000001, 6)
    w.write_bits(0, 1)
    for s in samples:
        w.write_bits(int(s) & ((1 << bps) - 1), bps)


def rice_residual(w: BitWriter, residuals, k: int):
    w.write_bits(0, 2)   # 4-bit method
    w.write_bits(0, 4)   # partition order 0
    w.write_bits(k, 4)
    for s in residuals:
        s = int(s)
        folded = (s << 1) if s >= 0 else (((-(s + 1)) << 1) | 1)
        w.write_unary(folded >> k)
        if k:
            w.write_bits(folded & ((1 << k) - 1), k)


def test_constant_subframe():
    w = BitWriter()
    stream_header(w, 1, BS)
    start = frame_header(w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0, 6)       # constant
    w.write_bits(0, 1)
    w.write_bits(-1234 & 0xFFFF, 16)
    finish_frame(w, start)
    dec, rate, ch, bps = decode_flac(w.get_bytes())
    assert (rate, ch, bps) == (RATE, 1, 16)
    np.testing.assert_array_equal(dec, np.full(BS, -1234, np.int32))


def _stereo_frames(chan_assign, ch0, ch1, bps0, bps1):
    w = BitWriter()
    stream_header(w, 2, BS)
    start = frame_header(w, chan_assign)
    verbatim_subframe(w, ch0, bps0)
    verbatim_subframe(w, ch1, bps1)
    finish_frame(w, start)
    return w.get_bytes()


def test_mid_side_stereo():
    rng = np.random.default_rng(0)
    L = rng.integers(-20000, 20000, BS).astype(np.int64)
    R = rng.integers(-20000, 20000, BS).astype(np.int64)
    mid = (L + R) >> 1
    side = L - R        # needs bps+1 bits
    data = _stereo_frames(0b1010, mid, side, 16, 17)
    dec, _, ch, _ = decode_flac(data)
    assert ch == 2
    np.testing.assert_array_equal(dec[0::2], L)
    np.testing.assert_array_equal(dec[1::2], R)


def test_left_side_stereo():
    rng = np.random.default_rng(1)
    L = rng.integers(-20000, 20000, BS).astype(np.int64)
    R = rng.integers(-20000, 20000, BS).astype(np.int64)
    side = L - R
    data = _stereo_frames(0b1000, L, side, 16, 17)
    dec, _, _, _ = decode_flac(data)
    np.testing.assert_array_equal(dec[0::2], L)
    np.testing.assert_array_equal(dec[1::2], R)


def test_right_side_stereo():
    rng = np.random.default_rng(2)
    L = rng.integers(-20000, 20000, BS).astype(np.int64)
    R = rng.integers(-20000, 20000, BS).astype(np.int64)
    side = L - R
    data = _stereo_frames(0b1001, side, R, 17, 16)
    dec, _, _, _ = decode_flac(data)
    np.testing.assert_array_equal(dec[0::2], L)
    np.testing.assert_array_equal(dec[1::2], R)


def test_lpc_subframe():
    """Order-1 LPC with coeff 1, shift 0 — pred = x[i-1]."""
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.integers(-50, 50, BS)).astype(np.int64)
    residual = x[1:] - x[:-1]
    w = BitWriter()
    stream_header(w, 1, BS)
    start = frame_header(w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0b100000, 6)        # LPC order 1 (1ooooo, o = order-1)
    w.write_bits(0, 1)
    w.write_bits(int(x[0]) & 0xFFFF, 16)   # warm-up
    w.write_bits(15 - 1, 4)          # precision 15
    w.write_bits(0, 5)               # shift 0
    w.write_bits(1, 15)              # coeff = +1
    rice_residual(w, residual, 6)
    finish_frame(w, start)
    dec, _, _, _ = decode_flac(w.get_bytes())
    np.testing.assert_array_equal(dec, x)


def test_wasted_bits():
    """Samples with k trailing zero bits stored at bps−k and shifted back."""
    vals = (np.arange(BS, dtype=np.int64) - 8) * 2   # all even
    w = BitWriter()
    stream_header(w, 1, BS)
    start = frame_header(w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0b000001, 6)        # verbatim
    w.write_bits(1, 1)               # wasted-bits flag
    w.write_unary(0)                 # unary 0 → 1 wasted bit
    for s in vals >> 1:
        w.write_bits(int(s) & 0x7FFF, 15)
    finish_frame(w, start)
    dec, _, _, _ = decode_flac(w.get_bytes())
    np.testing.assert_array_equal(dec, vals)


def test_escape_coded_partition():
    """Rice escape (param 0b1111): 5-bit raw width + raw signed residuals."""
    x = np.array([0, 5, -3, 7, 1, -8, 2, 0, 4, -6, 3, 1, -2, 5, 0, -1],
                 np.int64)
    residual = x[1:] - x[:-1]        # fixed order 1
    w = BitWriter()
    stream_header(w, 1, BS)
    start = frame_header(w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0b001001, 6)        # fixed order 1
    w.write_bits(0, 1)
    w.write_bits(int(x[0]) & 0xFFFF, 16)
    w.write_bits(0, 2)               # 4-bit method
    w.write_bits(0, 4)               # partition order 0
    w.write_bits(0xF, 4)             # escape
    w.write_bits(6, 5)               # 6-bit raw residuals
    for s in residual:
        w.write_bits(int(s) & 0x3F, 6)
    finish_frame(w, start)
    dec, _, _, _ = decode_flac(w.get_bytes())
    np.testing.assert_array_equal(dec, x)


def test_crc_mismatch_rejected():
    w = BitWriter()
    stream_header(w, 1, BS)
    start = frame_header(w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0, 6)
    w.write_bits(0, 1)
    w.write_bits(100, 16)
    finish_frame(w, start)
    data = bytearray(w.get_bytes())
    data[-1] ^= 0xFF  # corrupt the CRC16
    import pytest

    from glc.flac.decoder import FlacDecodeError
    with pytest.raises(FlacDecodeError):
        decode_flac(bytes(data))


def test_24bit_flac_load_path(tmp_path):
    """A 24-bit FLAC (which our encoder never writes) loads through the f32
    branch of load_audio_for_encode, normalized by 2^23 (audio.rs:72)."""
    from glc.io.audio import load_audio_for_encode

    vals = np.array([0, 1 << 20, -(1 << 20), (1 << 23) - 1, -(1 << 23), 42,
                     -7, 12345, -54321, 99, -99, 7, 1, -1, 2, -2], np.int64)
    w = BitWriter()
    stream_header(w, 1, BS, bps=24)
    start = len(w.buf)
    w.write_bits(0x3FFE, 14)
    w.write_bits(0, 1)
    w.write_bits(0, 1)
    w.write_bits(0b0110, 4)
    w.write_bits(0b1001, 4)
    w.write_bits(0b0000, 4)
    w.write_bits(0b110, 3)   # 24-bit sample size
    w.write_bits(0, 1)
    write_utf8_number(w, 0)
    w.write_byte(BS - 1)
    w.write_byte(crc8(bytes(w.buf[start:])))
    verbatim_subframe(w, vals, 24)
    finish_frame(w, start)

    p = tmp_path / "i24.flac"
    p.write_bytes(w.get_bytes())
    samples, rate, ch, pcm16 = load_audio_for_encode(p)
    assert (rate, ch, pcm16) == (RATE, 1, False)
    assert samples.dtype == np.float32
    np.testing.assert_allclose(samples, vals / float(1 << 23), atol=1e-9)
