"""Regression tests for the native-layer security review: crafted inputs
that previously caused wild pointer walks (SIGSEGV), signed-overflow UB,
unbounded decompression, or invalid output must now fail cleanly (or decode
to defined garbage)."""

import struct

import numpy as np
import pytest

from glc.container.bincode import BincodeError, deserialize_encoded
from glc.flac import decode_flac
from glc.flac.bitpack import BitWriter
from glc.flac.decoder import FlacDecodeError

import sys

sys.path.insert(0, "tests")
from test_flac_foreign import (  # noqa: E402
    BS,
    finish_frame,
    frame_header,
    rice_residual,
    stream_header,
)


def test_container_truncated_raw_length_no_crash():
    """A raw-frame record whose 8-byte length field sits inside the gapless
    tail used to move the parse pointer past `end`, underflow the remaining-
    bytes check, and walk the pointer terabytes away (SIGSEGV confirmed
    before the fix).  Must now raise BincodeError."""
    buf = struct.pack("<IHQ", 44100, 1, 0)          # header (14 B)
    buf += struct.pack("<Q", 2)                      # F = 2
    buf += struct.pack("<Q", 0)                      # outer = 0 (raw record)
    buf += struct.pack("<Q", 0)                      # sl = 0
    buf += b"\x01"                                   # raw tag
    # record ends exactly at end = len-16; the next 8 bytes (a huge L) live
    # in the gapless tail
    buf += struct.pack("<Q", (1 << 63) - (1 << 40))  # hostile L
    buf += b"\x00" * 8
    assert len(buf) == 55
    with pytest.raises(BincodeError):
        deserialize_encoded(buf)
    # milder variant that previously survived scan with a wild raw_len
    buf2 = bytearray(buf)
    struct.pack_into("<Q", buf2, 39, (1 << 63) - 4)
    with pytest.raises(BincodeError):
        deserialize_encoded(bytes(buf2))


def test_flac_lpc_overflow_stream_defined_behavior():
    """An LPC stream engineered to overflow the int64 predictor accumulator
    (confirmed UBSan abort before the fix) must decode to defined garbage
    or error — never UB."""
    order = 8
    w = BitWriter()
    stream_header(w, 1, BS)
    start = frame_header(w, 0b0000)
    w.write_bits(0, 1)
    w.write_bits(0b100000 | (order - 1), 6)  # LPC, order 8
    w.write_bits(0, 1)
    for _ in range(order):                   # warm-ups at int16 max
        w.write_bits(32767, 16)
    w.write_bits(15 - 1, 4)                  # precision 15
    w.write_bits(0, 5)                       # shift 0
    for _ in range(order):                   # coefficients at +16383
        w.write_bits(16383, 15)
    rice_residual(w, np.zeros(BS - order, np.int64), 0)
    finish_frame(w, start)
    try:
        dec, rate, ch, bps = decode_flac(w.get_bytes())
        assert len(dec) == BS  # garbage values, but defined and bounded
    except FlacDecodeError:
        pass  # rejecting is equally acceptable


def _constant_frame(w, frame_no, value=0):
    start = frame_header(w, 0b0000, frame_no)
    w.write_bits(0, 1)
    w.write_bits(0b000000, 6)  # constant
    w.write_bits(0, 1)
    w.write_bits(value & 0xFFFF, 16)
    finish_frame(w, start)


def test_flac_decompression_bomb_capped():
    """Frames beyond STREAMINFO's declared total must be rejected — a
    stream of cheap constant frames is otherwise a ~40000x expansion."""
    w = BitWriter()
    stream_header(w, 1, BS)          # declares exactly one block's worth
    _constant_frame(w, 0)
    _constant_frame(w, 1)            # exceeds the declared total
    with pytest.raises(FlacDecodeError):
        decode_flac(w.get_bytes())


def test_flac_silent_file_with_unknown_total_decodes():
    """si_total == 0 (unknown) must still allow legitimately huge expansion
    (silence compresses enormously) — bounded only by the absolute cap."""
    w = BitWriter()
    stream_header(w, 1, 0)           # total unknown
    for f in range(8):
        _constant_frame(w, f)
    dec, rate, ch, bps = decode_flac(w.get_bytes())
    assert len(dec) == 8 * BS
    assert not dec.any()


def test_native_pack_clamps_hostile_rice_params():
    """Out-of-range Rice parameters through the C ABI are clamped into
    0..14 — the output stays valid FLAC instead of UB shifts or escape-code
    corruption."""
    from glc.flac import bitpack
    from glc.flac.encoder import _pack
    from glc.native import get_native

    if get_native() is None:
        pytest.skip("native library unavailable")
    total = 4096
    i16 = np.zeros(total, np.int16)
    bs = 4096
    order = bitpack.predictor_order(bs, 5)
    po = bitpack.partition_order(bs, order, 5)
    md5 = __import__("hashlib").md5(i16.astype("<i2").tobytes()).digest()
    residuals = np.zeros(total, np.int32)
    rice_params = np.full(1 << po, 31, np.int8)  # hostile: all out of range
    data = _pack(i16, 1, 44100, 5, md5,
                 np.asarray([bs], np.int32), residuals, rice_params)
    dec, rate, ch, bps = decode_flac(data)
    np.testing.assert_array_equal(dec, i16.astype(np.int32))


def test_native_serialize_rejects_overflowing_nnz():
    """nnz counts near 2^62 must fail the overflow-guarded size pass (the
    wrapped total previously undersized the allocation)."""
    from glc.container.bincode import _native_serialize
    from glc.container.schema import (
        PAIR_DTYPE,
        AudioHeader,
        EncodedAudio,
        FrameSet,
        GaplessInfo,
    )
    from glc.native import get_native

    if get_native() is None:
        pytest.skip("native library unavailable")
    fs = FrameSet(
        np.array([[(1 << 62) + 10]], np.int64),
        np.empty(0, PAIR_DTYPE),
        np.ones((1, 1), np.float32),
        np.zeros(1, bool),
        np.empty((0, 2048), np.int16),
    )
    ea = EncodedAudio(AudioHeader(44100, 1, 0), fs, GaplessInfo(512, 0, 0))
    assert _native_serialize(ea) is None  # clean refusal, not heap damage


def test_native_fill_self_bounding_against_mutated_buffer():
    """The fill pass must not trust scan's offsets: if the buffer changes
    between scan and fill (a C-ABI caller bug), fill must return an error
    code instead of overrunning the caller's exactly-sized buffers.  Calls
    the two passes directly with a buffer that is valid at scan time and
    hostile at fill time."""
    import ctypes as c

    from glc.container.schema import PAIR_DTYPE
    from glc.native import get_native

    lib = get_native()
    if lib is None:
        pytest.skip("native library unavailable")

    # valid container: 1 channel, 2 MDCT frames, 3 pairs total
    buf = bytearray()
    buf += struct.pack("<IHQ", 44100, 1, 0)
    buf += struct.pack("<Q", 2)                       # F
    for cnt in (2, 1):
        buf += struct.pack("<Q", 1)                   # outer = C
        buf += struct.pack("<Q", cnt)                 # nnz
        buf += b"\x01\x00\x02\x00" * cnt              # pairs
        buf += struct.pack("<Q", 1) + struct.pack("<f", 1.0) + b"\x00"
    buf += struct.pack("<IIQ", 512, 0, 0)

    arr = np.frombuffer(bytes(buf), np.uint8).copy()
    bp = arr.ctypes.data_as(c.POINTER(c.c_uint8))
    sr = c.c_uint32(); ch = c.c_uint16(); ts = c.c_uint64()
    ed = c.c_uint32(); pad = c.c_uint32(); ol = c.c_uint64()
    F = c.c_int64(); K = c.c_int64(); R = c.c_int64(); L = c.c_int64()
    rc = lib.glc_container_scan(bp, len(arr), c.byref(sr), c.byref(ch),
                                c.byref(ts), c.byref(ed), c.byref(pad),
                                c.byref(ol), c.byref(F), c.byref(K),
                                c.byref(R), c.byref(L))
    assert rc == 0 and K.value == 3

    # mutate AFTER scan: inflate frame 0's pair count so the old fill would
    # memcpy far past the 3-record pairs buffer
    struct.pack_into("<Q", arr, 22 + 8, 1 << 20)

    nnz = np.zeros((2, 1), np.int64)
    pairs = np.empty(K.value, PAIR_DTYPE)
    scales = np.zeros((2, 1), np.float32)
    raw_mask = np.zeros(2, np.uint8)
    raw_pcm = np.empty((0, 2048), np.int16)
    rc = lib.glc_container_fill(
        bp, len(arr), F.value, 1,
        nnz.ctypes.data_as(c.POINTER(c.c_int64)),
        pairs.view(np.uint8).ctypes.data_as(c.POINTER(c.c_uint8)), K.value,
        scales.ctypes.data_as(c.POINTER(c.c_float)),
        raw_mask.ctypes.data_as(c.POINTER(c.c_uint8)),
        raw_pcm.ctypes.data_as(c.POINTER(c.c_int16)), 0, 2048,
    )
    assert rc != 0  # clean refusal, not a heap overrun
