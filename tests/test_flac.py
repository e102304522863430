"""FLAC encoder conformance-by-round-trip (mirrors reference tests/test_flac.rs).

The oracle is our independent C++ FLAC decoder (native/glc_native.cpp),
playing the role claxon plays for the reference (test_flac.rs decodes the
hand-written encoder's output with the external claxon crate).
"""

import numpy as np
import pytest

from glc.flac import decode_flac, encode_flac, encode_flac_with_level
from glc.flac.encoder import FlacError, _compute_frame_data
from glc.flac import bitpack
from glc.io.audio import convert_f32_to_i16
from utils import generate_sine_wave, generate_white_noise


def roundtrip_rms_error(samples, rate, channels, level=5):
    data = encode_flac_with_level(samples, rate, channels, level)
    decoded, r, c, b = decode_flac(data)
    assert r == rate and c == channels and b == 16
    dec_f = decoded.astype(np.float64) / 32767.0
    orig = np.asarray(samples, np.float64)[: len(dec_f)]
    assert len(dec_f) == len(samples)
    return float(np.sqrt(np.mean((orig - dec_f) ** 2)))


def test_flac_silence():
    samples = np.zeros(44100, np.float32)
    assert roundtrip_rms_error(samples, 44100, 1) < 1e-4


def test_flac_dc_offset():
    samples = np.full(44100, 0.25, np.float32)
    assert roundtrip_rms_error(samples, 44100, 1) < 1e-4


def test_flac_sine():
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    assert roundtrip_rms_error(samples, 44100, 1) < 1e-4


def test_flac_noise():
    samples = generate_white_noise(44100, 1, 1.0, 77)
    assert roundtrip_rms_error(samples, 44100, 1) < 1e-4


def test_flac_stereo():
    samples = generate_sine_wave(440.0, 44100, 2, 1.0)
    assert roundtrip_rms_error(samples, 44100, 2) < 1e-4


@pytest.mark.parametrize("rate", [48000, 96000])
def test_flac_sample_rates(rate):
    samples = generate_sine_wave(440.0, rate, 1, 0.5)
    assert roundtrip_rms_error(samples, rate, 1) < 1e-4


def test_flac_minimum_length():
    """16 samples per channel is the encoder's minimum (flac.rs:963-969)."""
    samples = np.linspace(-0.5, 0.5, 16).astype(np.float32)
    assert roundtrip_rms_error(samples, 44100, 1) < 1e-4


def test_flac_too_short_rejected():
    with pytest.raises(FlacError):
        encode_flac(np.zeros(15, np.float32), 44100, 1)


def test_flac_bad_level_rejected():
    with pytest.raises(FlacError):
        encode_flac_with_level(np.zeros(100, np.float32), 44100, 1, 9)


@pytest.mark.parametrize("level", list(range(9)))
def test_flac_all_levels(level):
    """test_flac.rs:132-160 — every level produces a decodable stream with
    the right sample count, bit-exact to the i16 conversion."""
    samples = generate_sine_wave(440.0, 44100, 2, 0.5)
    data = encode_flac_with_level(samples, 44100, 2, level)
    decoded, r, c, b = decode_flac(data)
    assert (r, c, b) == (44100, 2, 16)
    expected = convert_f32_to_i16(samples).astype(np.int32)
    np.testing.assert_array_equal(decoded, expected)


def test_flac_partial_last_block():
    """A stream length not divisible by the block size exercises the
    uncommon-blocksize header path (flac.rs:853-861)."""
    samples = generate_sine_wave(440.0, 44100, 1, 0.1)  # 4410 samples
    data = encode_flac_with_level(samples, 44100, 1, 5)  # bs 4096 + 314
    decoded, _, _, _ = decode_flac(data)
    np.testing.assert_array_equal(
        decoded, convert_f32_to_i16(samples).astype(np.int32)
    )


def test_native_and_python_packers_byte_identical():
    """The pure-Python fallback packer must produce the same bytes as the
    native C++ packer."""
    samples = generate_sine_wave(440.0, 44100, 2, 0.25)
    level = 5
    native_bytes = encode_flac_with_level(samples, 44100, 2, level)

    import hashlib
    i16 = convert_f32_to_i16(samples)
    md5 = hashlib.md5(i16.astype("<i2").tobytes()).digest()
    block_sizes, residuals, rice_params = _compute_frame_data(i16, 2, level)
    py_bytes = bitpack.pack_stream(
        i16, 2, 44100, level, md5, block_sizes, residuals, rice_params
    )
    assert py_bytes == native_bytes


def test_order_helpers_match_native():
    """Python and C++ predictor/partition order functions must agree."""
    from glc.native import get_native
    lib = get_native()
    if lib is None:
        pytest.skip("native library unavailable")
    for bs in (16, 100, 1000, 1024, 1152, 4096, 314):
        for level in range(9):
            po_py = bitpack.predictor_order(bs, level)
            assert po_py == lib.glc_flac_predictor_order(bs, level)
            part_py = bitpack.partition_order(bs, po_py, level)
            assert part_py == lib.glc_flac_partition_order(bs, po_py, level)


def test_flac_four_channels():
    """FLAC multichannel: independent channel assignment code = channels-1
    (flac.rs:821-833), round-tripped through the native decoder."""
    base = generate_sine_wave(330.0, 44100, 1, 0.5)
    C = 4
    interleaved = np.empty(len(base) * C, np.float32)
    for c in range(C):
        interleaved[c::C] = base * np.float32(0.4 + 0.1 * c)
    data = encode_flac_with_level(interleaved, 44100, C, 5)
    decoded, r, ch, b = decode_flac(data)
    assert (r, ch, b) == (44100, C, 16)
    np.testing.assert_array_equal(
        decoded, convert_f32_to_i16(interleaved).astype(np.int32)
    )


def test_host_and_device_flac_stats_agree():
    """flac_block_stats (device) and flac_block_stats_host (numpy) are the
    same exact integer math."""
    import jax
    from glc.flac.ops import flac_block_stats, flac_block_stats_host

    rng = np.random.default_rng(9)
    x = rng.integers(-32768, 32767, (16, 1152)).astype(np.int32)
    for order, po in ((1, 0), (2, 2), (4, 4)):
        rd, ld, hd = flac_block_stats(jax.device_put(x), order=order, po=po)
        rh, lh, hh = flac_block_stats_host(x, order=order, po=po)
        np.testing.assert_array_equal(np.asarray(rd), rh)
        np.testing.assert_array_equal(np.asarray(ld), lh)
        np.testing.assert_array_equal(np.asarray(hd), hh)


def test_flac_last_block_equals_predictor_order():
    """Regression (QUIRKS.md Q15): a last partial block whose size equals
    the predictor order leaves the first partition empty; RFC 9639 still
    requires its Rice parameter.  The reference skips it (flac.rs:632-638),
    emitting invalid FLAC — we write it."""
    for level, order in ((1, 1), (2, 2), (4, 3), (5, 4)):
        bs = 1152 if level <= 2 else 4096
        total = 2 * bs + order  # last block has exactly `order` samples
        samples = generate_sine_wave(440.0, 44100, 1, 1.0)[:total]
        data = encode_flac_with_level(samples, 44100, 1, level)
        decoded, _, _, _ = decode_flac(data)
        np.testing.assert_array_equal(
            decoded, convert_f32_to_i16(samples).astype(np.int32)
        )


def test_flac_pack_rejects_bad_geometry():
    """Native packer validates block sizes and sample coverage."""
    import ctypes as c
    from glc.native import get_native
    lib = get_native()
    if lib is None:
        pytest.skip("native library unavailable")
    i16 = np.zeros(100, np.int16)
    md5 = bytes(16)
    bsc = np.array([0], np.int32)  # invalid block size
    res = np.zeros(0, np.int32)
    rp = np.zeros(0, np.int8)
    out = c.POINTER(c.c_uint8)(); out_len = c.c_int64()
    rc = lib.glc_flac_pack(
        i16.ctypes.data_as(c.POINTER(c.c_int16)), len(i16), 1, 44100, 0,
        (c.c_uint8 * 16).from_buffer_copy(md5),
        bsc.ctypes.data_as(c.POINTER(c.c_int32)), 1,
        res.ctypes.data_as(c.POINTER(c.c_int32)),
        rp.ctypes.data_as(c.POINTER(c.c_int8)),
        c.byref(out), c.byref(out_len))
    assert rc == -3


def test_native_block_stats_matches_numpy():
    """The native single-pass block stats (glc_flac_block_stats) must be
    bit-identical to the numpy twin across predictor orders and partition
    orders — it feeds the byte stream, so any divergence is a corrupt
    FLAC."""
    import numpy as np

    from glc.flac.encoder import _block_stats_fast
    from glc.flac.ops import flac_block_stats_host
    from glc.native import get_native

    if get_native() is None:
        import pytest

        pytest.skip("native library unavailable (numpy twin is the path)")
    rng = np.random.default_rng(42)
    for order in range(5):
        for po, bs in ((0, 1152), (2, 1152), (4, 4096), (6, 4096)):
            x = rng.integers(-32768, 32768, (7, bs), dtype=np.int32)
            got = _block_stats_fast(x, order, po)
            want = flac_block_stats_host(x, order=order, po=po)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    # extreme values: the order-4 kernel's 16x range must not misbehave
    x = np.full((2, 256), 32767, np.int32)
    x[:, ::2] = -32768
    got = _block_stats_fast(x, 4, 2)
    want = flac_block_stats_host(x, order=4, po=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
