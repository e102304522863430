"""Pure-Python FLAC decoder fallback — equivalence with the native decoder.

The reference always has FLAC input because claxon is a hard dependency
(reference src/audio.rs:66-83); our native decoder needs g++.  The Python
fallback (glc/flac/pydecoder.py) keeps FLAC input and the encoder's
conformance oracle alive without a toolchain; these tests pin it
bit-identical to the native implementation on both well-formed and hostile
streams.
"""

import numpy as np
import pytest

from utils import generate_sine_wave, generate_white_noise

from glc.flac.decoder import decode_flac
from glc.flac.encoder import encode_flac_i16_with_level
from glc.flac.pydecoder import decode_flac_python
from glc.native import get_native


def _encode(pcm, rate, ch, level=5):
    return bytes(encode_flac_i16_with_level(pcm, rate, ch, level))


def _i16(x):
    return np.clip(x * 32767.0, -32768, 32767).astype(np.int16)


CASES = [
    ("sine_stereo", _i16(generate_sine_wave(440.0, 44100, 2, 0.4)), 2, 44100),
    ("noise_mono", _i16(generate_white_noise(48000, 1, 0.3, 7)), 1, 48000),
    ("silence", np.zeros(4096, np.int16), 1, 44100),
    ("minimum_16", np.arange(16, dtype=np.int16), 1, 44100),
]


@pytest.mark.parametrize("name,pcm,ch,rate", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("level", [0, 5, 8])
def test_python_decoder_matches_native(name, pcm, ch, rate, level):
    if get_native() is None:
        pytest.skip("native library unavailable — nothing to compare against")
    data = _encode(pcm, rate, ch, level)
    s_n, r_n, c_n, b_n = decode_flac(data)
    s_p, r_p, c_p, b_p = decode_flac_python(data)
    assert (r_n, c_n, b_n) == (r_p, c_p, b_p)
    assert np.array_equal(s_n, s_p)


def test_python_decoder_roundtrips_pcm():
    """Without any native comparison: decoded samples equal the source PCM
    (FLAC is lossless; reference tests/test_flac.rs:44)."""
    pcm = _i16(generate_sine_wave(880.0, 44100, 2, 0.2))
    samples, rate, ch, bps = decode_flac_python(_encode(pcm, 44100, 2))
    assert (rate, ch, bps) == (44100, 2, 16)
    assert np.array_equal(samples.astype(np.int16), pcm)


@pytest.mark.parametrize("bad,code", [
    (b"", -1),
    (b"fLaC", -1),              # < 8 bytes: magic check fails first
    (b"fLaC\x80\x00\x00", -1),  # still < 8 bytes
    (b"fLaC\x00\x00\x00\xff", -2),  # truncated metadata block
    (b"not-flac" + b"\x00" * 64, -1),
])
def test_python_decoder_error_codes(bad, code):
    with pytest.raises(ValueError, match=str(code)):
        decode_flac_python(bad)


def test_python_decoder_truncated_stream_matches_native_error():
    if get_native() is None:
        pytest.skip("native library unavailable")
    data = _encode(np.zeros(4096, np.int16), 44100, 1)[:-3]
    err_n = err_p = None
    try:
        decode_flac(data)
    except ValueError as e:
        err_n = str(e)
    try:
        decode_flac_python(data)
    except ValueError as e:
        err_p = str(e)
    assert err_n is not None and err_p is not None
    assert err_n.split()[-1] == err_p.split()[-1]  # same error code


def test_differential_fuzz_python_vs_native():
    """Differential fuzz: on mutated streams the two decoders must agree —
    same samples on acceptance, same error code on rejection.  This is what
    makes the Python fallback a true twin rather than a lookalike: hostile
    inputs exercise paths (CRC failures, malformed subframes, truncation)
    that well-formed encoder output never reaches."""
    if get_native() is None:
        pytest.skip("native library unavailable")
    base = _encode(_i16(generate_sine_wave(330.0, 44100, 2, 0.25)), 44100, 2)
    rng = np.random.default_rng(11)
    agree_err = agree_ok = 0
    for trial in range(80):
        buf = bytearray(base)
        kind = trial % 3
        if kind == 0:    # byte flip anywhere
            i = int(rng.integers(0, len(buf)))
            buf[i] ^= int(rng.integers(1, 256))
        elif kind == 1:  # truncation
            buf = buf[: int(rng.integers(0, len(buf)))]
        else:            # short random injection
            i = int(rng.integers(0, len(buf) - 4))
            buf[i : i + 4] = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        data = bytes(buf)
        out_n = err_n = out_p = err_p = None
        try:
            out_n = decode_flac(data)
        except ValueError as e:
            err_n = str(e).split()[-1]
        try:
            out_p = decode_flac_python(data)
        except ValueError as e:
            err_p = str(e).split()[-1]
        assert (err_n is None) == (err_p is None), (
            f"trial {trial}: native={err_n} python={err_p}"
        )
        if err_n is not None:
            assert err_n == err_p, f"trial {trial}: {err_n} != {err_p}"
            agree_err += 1
        else:
            s_n, r_n, c_n, b_n = out_n
            s_p, r_p, c_p, b_p = out_p
            assert (r_n, c_n, b_n) == (r_p, c_p, b_p)
            assert np.array_equal(s_n, s_p), f"trial {trial}"
            agree_ok += 1
    assert agree_err > 10  # most mutations must be rejected (CRC coverage)
