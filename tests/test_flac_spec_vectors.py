"""RFC 9639 byte-literal conformance fixtures.

Both of this repo's FLAC decoders (native C++ and the pure-Python twin) were
written by the same builder, so cross-checking them against each other — or
against streams assembled with the library's own BitWriter — cannot catch a
shared misreading of the spec.  The reference had claxon as a genuinely
independent oracle (reference tests/test_flac.rs:1-44, src/audio.rs:66-83);
no third-party FLAC implementation exists in this environment, so these
fixtures are the independent evidence available:

* the CRC-8 / CRC-16 check values are PUBLISHED constants for the
  catalogued parameterizations RFC 9639 §9.2 specifies (CRC-8/SMBUS and
  CRC-16/UMTS: crc("123456789") = 0xF4 / 0xFEE8), and the MD5 vectors are
  RFC 1321's own test suite — not derived from this repo's code at all;
* the four fixture streams below are BYTE LITERALS, hand-derived field by
  field from the RFC 9639 text (derivations in comments), written with
  fresh throwaway bit math, NOT with glc's BitWriter / CRC / encoder
  code — a decoder bug that this repo's generator code shares cannot
  round-trip its way past a literal;
* stream B doubles as a spec-derived golden for the ENCODER's framing:
  level 0 on 16 samples must produce exactly these bytes (block size
  clamps to 16, level 0 ⇒ verbatim subframe, reference flac.rs:986-1000).

Every stream is decoded with BOTH decoders and must yield the exact
expected samples and stream parameters.
"""

import hashlib

import numpy as np
import pytest

from glc.flac.decoder import decode_flac
from glc.flac.encoder import encode_flac_i16_with_level
from glc.flac.pydecoder import decode_flac_python
from glc.native import get_native

DECODERS = [pytest.param(decode_flac_python, id="python")]
if get_native() is not None:
    DECODERS.append(pytest.param(decode_flac, id="native"))


# --------------------------------------------------------------------------
# Shared preamble of all four streams (mono variants):
#   664c6143                  "fLaC" magic (RFC 9639 §8)
#   80 000022                 metadata block header: last=1, type=0
#                             (STREAMINFO), length 34 (§8.1)
# STREAMINFO body (§8.2), 34 bytes:
#   0010 0010                 min/max block size 16
#   000000 000000             min/max frame size unknown (0)
#   0ac44 <<< 20 bits         sample rate 44100 (0x0AC44)
#   000   <<< 3 bits          channels-1 = 0 (mono)
#   01111 <<< 5 bits          bits-per-sample-1 = 15 (16-bit)
#   0x000000010 <<< 36 bits   total samples = 16
#     → the 20+3+5+36 bits pack to bytes 0a c4 4f 00 00 00 00 10
#   <16 bytes>                MD5 of the little-endian int16 PCM (§8.2)
#
# Frame header (§9.1) for block size 16, 44.1 kHz, mono, 16-bit, frame 0:
#   fff8                      11111111111110 sync + 0 reserved + 0 fixed-
#                             blocksize strategy
#   69                        0110 = block size "8-bit value-1 follows",
#                             1001 = 44.1 kHz
#   08                        0000 = mono (independent), 100 = 16-bit, 0
#   00                        UTF-8-coded frame number 0
#   0f                        block size - 1 = 15
#   <1 byte>                  CRC-8 (poly 0x07, init 0) of the header bytes
# ...subframe(s), byte padding, then CRC-16 (poly 0x8005, init 0) of the
# whole frame (§9.3).
# --------------------------------------------------------------------------


# Stream A: one CONSTANT subframe (§9.2.1), value 42.
#   Subframe header 00: 0 pad, 000000 = constant, 0 wasted-bits flag;
#   then one 16-bit sample 002a.  Frame CRC-16 = c67f.
STREAM_A = bytes.fromhex(
    "664c6143800000220010001000000000"
    "00000ac440f000000010fc1f0eb1bdd4"
    "020cc1f5879b079e5342fff86908000f"
    "3000002ac67f"
)

# Stream B: one VERBATIM subframe (§9.2.2), samples -8..7.
#   Subframe header 02: 0 pad, 000001 = verbatim, 0 wasted bits;
#   then 16 × 16-bit two's-complement samples fff8..0007. CRC-16 = 40aa.
STREAM_B = bytes.fromhex(
    "664c6143800000220010001000000000"
    "00000ac440f000000010f07a1d9d17fc"
    "b0a078ea2dddf783d142fff86908000f"
    "3002fff8fff9fffafffbfffcfffdfffe"
    "ffff0000000100020003000400050006"
    "000740aa"
)

# Stream C: FIXED order-2 predictor (§9.2.3) over x[i] = i², Rice k=1.
#   Subframe header 14: 0 pad, 001010 = fixed order 2, 0 wasted bits;
#   warmups 0000 0001 (x[0]=0, x[1]=1);
#   residual (§9.2.7): 00 = 4-bit Rice method, 0000 = partition order 0,
#   0001 = k=1; every residual e = x[i] − 2x[i−1] + x[i−2] = 2, zigzag
#   (§9.2.7.1: n≥0 → 2n) = 4 → quotient 10 unary "001", remainder 0 —
#   14 × "0010" = 888...80 after the 4-bit header nibble, 4 pad bits.
#   CRC-16 = b6c1.
STREAM_C = bytes.fromhex(
    "664c6143800000220010001000000000"
    "00000ac440f00000001013fce363a1d5"
    "5cfee5df7c0486a313e8fff86908000f"
    "301400000001004888888888888880b6"
    "c1"
)

# Stream D: STEREO (channels-1 = 1 → streaminfo byte 42f0...020 for
# 2 channels / total 32), channel assignment 0001 = independent stereo
# (frame header byte 18), TWO frames (frame numbers 00 and 01, distinct
# header CRCs 92/87), each with two constant subframes L=100 (0064) and
# R=-100 (ff9c).
STREAM_D = bytes.fromhex(
    "664c6143800000220010001000000000"
    "00000ac442f0000000200bf4e24bb07f"
    "adafe801fa276880d046fff86918000f"
    "9200006400ff9cfd53fff86918010f87"
    "00006400ff9cef63"
)


# Stream E: FIXED order-1 with PARTITION ORDER 1 (§9.2.7): two partitions
# — partition 0 carries (16>>1) − order = 7 residuals at k=0 (zigzag(2)=4
# → unary 00001), partition 1 carries 8 residuals at k=1 (q=2 → 001, r=0).
#   Subframe 12: 0 pad, 001001 = fixed order 1, 0 wasted; warmup 0000;
#   residual 00 + 0001 (order 1) + [0000, 7×00001] + [0001, 8×0010].
STREAM_E = bytes.fromhex(
    "664c614380000022001000100000000000000ac440f000000010ff4368299c50"
    "dbff7a7bd15e91f91a76fff86908000f301200000402108421089111111100ec"
    "9f"
)

# Stream F: fixed order-0 with an ESCAPE-coded partition (§9.2.7.1):
# 4-bit params 1111 escapes, then 5 bits give the raw width (5), then 16
# residuals (= the samples, order 0) as raw 5-bit two's complement.
#   Subframe 10: 0 pad, 001000 = fixed order 0, 0 wasted;
#   residual 00 + 0000 + 1111 + 00101 + 16×5-bit raws + pad.
STREAM_F = bytes.fromhex(
    "664c614380000022001000100000000000000ac440f000000010f07a1d9d17fc"
    "b0a078ea2dddf783d142fff86908000f301003cb8ceb7cefbe008864298e5d33"
)


@pytest.mark.parametrize("decode", DECODERS)
class TestSpecVectors:
    def _check(self, decode, stream, expected, channels):
        samples, rate, ch, bps = decode(stream)
        assert rate == 44100
        assert ch == channels
        assert bps == 16
        np.testing.assert_array_equal(
            np.asarray(samples, np.int64), np.asarray(expected, np.int64)
        )

    def test_constant_subframe(self, decode):
        self._check(decode, STREAM_A, [42] * 16, 1)

    def test_verbatim_subframe(self, decode):
        self._check(decode, STREAM_B, list(range(-8, 8)), 1)

    def test_fixed_order2_rice(self, decode):
        self._check(decode, STREAM_C, [i * i for i in range(16)], 1)

    def test_stereo_two_frames(self, decode):
        self._check(decode, STREAM_D, [100, -100] * 32, 2)

    def test_fixed_order1_two_partitions(self, decode):
        self._check(decode, STREAM_E, [2 * i for i in range(16)], 1)

    def test_escape_coded_partition(self, decode):
        self._check(decode, STREAM_F, list(range(-8, 8)), 1)


def test_encoder_framing_golden_level0():
    """Level 0 on 16 mono samples must emit EXACTLY stream B: block size
    clamps to the sample count (flac.rs:986-1000), level 0 selects the
    verbatim subframe (flac.rs:688-704), and every remaining field is
    fixed by RFC 9639 — so the whole stream is derivable from the spec
    without reference to the encoder's code."""
    pcm = np.arange(-8, 8, dtype=np.int16)
    got = encode_flac_i16_with_level(pcm, 44100, 1, 0)
    assert got == STREAM_B


# --------------------------------------------------------------------------
# Published known-answer vectors for the primitive layer.
# --------------------------------------------------------------------------


def test_crc8_published_check_value():
    """RFC 9639 §9.2's frame-header CRC is the catalogued CRC-8/SMBUS
    (poly 0x07, init 0, MSB-first): check("123456789") = 0xF4."""
    from glc.flac.bitpack import crc8

    assert crc8(b"123456789") == 0xF4
    assert crc8(b"") == 0x00


def test_crc16_published_check_value():
    """RFC 9639 §9.2's frame CRC is the catalogued CRC-16/UMTS
    (poly 0x8005, init 0, MSB-first): check("123456789") = 0xFEE8."""
    from glc.flac.bitpack import crc16

    assert crc16(b"123456789") == 0xFEE8
    assert crc16(b"") == 0x0000


def test_md5_rfc1321_vectors():
    """The STREAMINFO MD5 must be real MD5 (RFC 1321 test suite); the
    encoder hashes the little-endian int16 stream with it, so pin the
    exact digest of a known PCM buffer too."""
    assert hashlib.md5(b"").hexdigest() == "d41d8cd98f00b204e9800998ecf8427e"
    assert hashlib.md5(b"abc").hexdigest() == (
        "900150983cd24fb0d6963f7d28e17f72"
    )
    pcm = np.array([42] * 16, np.int16)
    stream = encode_flac_i16_with_level(pcm, 44100, 1, 5)
    md5_field = stream[4 + 4 + 18 : 4 + 4 + 34]
    assert md5_field == hashlib.md5(pcm.astype("<i2").tobytes()).digest()
    assert md5_field.hex() == "fc1f0eb1bdd4020cc1f5879b079e5342"


@pytest.mark.parametrize("decode", DECODERS)
def test_corrupt_crc_rejected(decode):
    """Flipping the last CRC-16 byte must fail both decoders (the literal
    streams above double as a negative-control corpus)."""
    bad = bytearray(STREAM_A)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError):
        decode(bytes(bad))
