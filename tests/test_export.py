"""Codec → file-export round trips (mirrors reference tests/test_export.rs)
plus WAV reader/writer coverage (the hound-equivalent layer)."""

import numpy as np
import pytest

from glc import Decoder, Encoder
from glc.io.audio import (
    AudioFormatError,
    export_to_flac,
    export_to_wav,
    load_audio_file_lossless,
)
from glc.io.wav import read_wav, write_wav
from utils import generate_sine_wave


def encode_decode(samples, rate, channels):
    encoded = Encoder(rate).encode(samples, channels)
    return Decoder(channels, rate).decode(encoded)


@pytest.mark.parametrize("export,ext", [(export_to_wav, "wav"),
                                        (export_to_flac, "flac")])
def test_decode_export_reload(tmp_path, export, ext):
    """test_export.rs:20-108 — decode, export, reload: rate/channels/count
    preserved."""
    samples = generate_sine_wave(440.0, 44100, 2, 1.0)
    decoded = encode_decode(samples, 44100, 2)
    out = tmp_path / f"out.{ext}"
    export(out, decoded, 44100, 2)
    reloaded, rate, channels = load_audio_file_lossless(out)
    assert rate == 44100
    assert channels == 2
    assert len(reloaded) == len(decoded)


def test_gapless_playlist_concat_export(tmp_path):
    """test_export.rs:110-166 — 3-file playlist decoded and concatenated into
    one gapless export preserves the exact total sample count."""
    files = [
        generate_sine_wave(440.0, 44100, 1, 1.0),
        generate_sine_wave(880.0, 44100, 1, 1.0),
        generate_sine_wave(660.0, 44100, 1, 1.0),
    ]
    all_samples = np.concatenate([encode_decode(f, 44100, 1) for f in files])
    assert len(all_samples) == sum(len(f) for f in files)

    out = tmp_path / "album.flac"
    export_to_flac(out, all_samples, 44100, 1)
    reloaded, rate, channels = load_audio_file_lossless(out)
    assert rate == 44100 and channels == 1
    assert len(reloaded) == len(all_samples)


def test_wav_int16_round_trip(tmp_path):
    samples = generate_sine_wave(1000.0, 48000, 2, 0.25)
    p = tmp_path / "t.wav"
    write_wav(p, samples, 48000, 2)
    loaded, rate, channels = read_wav(p)
    assert (rate, channels) == (48000, 2)
    assert len(loaded) == len(samples)
    # 16-bit floor: write truncates ×32767 (audio.rs:14), read divides by
    # 32768 (audio.rs:55) — max error ≈ 2/32768
    assert float(np.abs(loaded - samples).max()) < 2.2 / 32768


def test_wav_float32_passthrough(tmp_path):
    """Float WAVs pass through unscaled (audio.rs:46-50)."""
    import struct
    samples = np.array([0.0, 0.5, -0.5, 1.0], np.float32)
    payload = samples.astype("<f4").tobytes()
    header = b"".join([
        b"RIFF", struct.pack("<I", 36 + len(payload)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 3, 1, 44100, 44100 * 4, 4, 32),
        b"data", struct.pack("<I", len(payload)),
    ])
    p = tmp_path / "f32.wav"
    p.write_bytes(header + payload)
    loaded, rate, channels = read_wav(p)
    np.testing.assert_array_equal(loaded, samples)


def test_wav_24bit(tmp_path):
    import struct
    vals = np.array([0, 1 << 22, -(1 << 22), (1 << 23) - 1], np.int32)
    b = np.zeros((len(vals), 3), np.uint8)
    b[:, 0] = vals & 0xFF
    b[:, 1] = (vals >> 8) & 0xFF
    b[:, 2] = (vals >> 16) & 0xFF
    payload = b.tobytes()
    header = b"".join([
        b"RIFF", struct.pack("<I", 36 + len(payload)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, 44100, 44100 * 3, 3, 24),
        b"data", struct.pack("<I", len(payload)),
    ])
    p = tmp_path / "i24.wav"
    p.write_bytes(header + payload)
    loaded, _, _ = read_wav(p)
    np.testing.assert_allclose(loaded, vals / float(1 << 23), atol=1e-7)


def test_unsupported_extension(tmp_path):
    p = tmp_path / "t.mp3"
    p.write_bytes(b"junk")
    with pytest.raises(AudioFormatError):
        load_audio_file_lossless(p)


def test_no_extension(tmp_path):
    p = tmp_path / "noext"
    p.write_bytes(b"junk")
    with pytest.raises(AudioFormatError):
        load_audio_file_lossless(p)


def test_album_playlist_export(tmp_path):
    """Library-level gapless album join (glc.album; ui.rs:291-402)."""
    from glc.album import decode_playlist, export_playlist_to_flac
    from glc import Encoder, save_encoded
    from glc.flac.decoder import read_flac

    paths = []
    total = 0
    for i, freq in enumerate((440.0, 880.0)):
        s = generate_sine_wave(freq, 44100, 1, 0.7)
        total += len(s)
        p = tmp_path / f"t{i}.glc"
        save_encoded(Encoder(44100).encode(s, 1), p)
        paths.append(p)

    samples, rate, channels = decode_playlist(paths)
    assert (rate, channels) == (44100, 1)
    assert len(samples) == total

    out = tmp_path / "album.flac"
    export_playlist_to_flac(paths, out, 5)
    reloaded, r, c = read_flac(out)
    assert len(reloaded) == total


def test_album_mismatched_rates_rejected(tmp_path):
    from glc.album import decode_playlist
    from glc import Encoder, save_encoded

    p1 = tmp_path / "a.glc"
    p2 = tmp_path / "b.glc"
    save_encoded(Encoder(44100).encode(
        generate_sine_wave(440.0, 44100, 1, 0.5), 1), p1)
    save_encoded(Encoder(48000).encode(
        generate_sine_wave(440.0, 48000, 1, 0.5), 1), p2)
    with pytest.raises(ValueError):
        decode_playlist([p1, p2])


def test_album_empty_playlist_rejected():
    from glc.album import decode_playlist
    with pytest.raises(ValueError):
        decode_playlist([])


def _wav_bytes(fmt_body: bytes, data_body: bytes) -> bytes:
    import struct

    chunks = (b"fmt " + struct.pack("<I", len(fmt_body)) + fmt_body
              + b"data" + struct.pack("<I", len(data_body)) + data_body)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def test_wav_8bit_offset_binary(tmp_path):
    """8-bit WAV is unsigned offset-binary (hound normalizes /2^7)."""
    import struct

    vals = np.array([0, 128, 255, 64], np.uint8)
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 8000, 1, 8)
    p = tmp_path / "u8.wav"
    p.write_bytes(_wav_bytes(fmt, vals.tobytes()))
    from glc.io.wav import read_wav

    s, rate, ch = read_wav(p)
    assert (rate, ch) == (8000, 1)
    np.testing.assert_allclose(
        s, (vals.astype(np.int16) - 128) / 128.0, atol=0
    )


def test_wav_32bit_int_and_float64(tmp_path):
    import struct

    i32 = np.array([0, 2**31 - 1, -(2**31), 12345678], "<i4")
    fmt = struct.pack("<HHIIHH", 1, 1, 44100, 44100 * 4, 4, 32)
    p = tmp_path / "i32.wav"
    p.write_bytes(_wav_bytes(fmt, i32.tobytes()))
    from glc.io.wav import read_wav

    s, _r, _c = read_wav(p)
    np.testing.assert_allclose(s, (i32 / 2.0**31).astype(np.float32))

    f64 = np.array([0.0, 0.5, -1.0, 0.125], "<f8")
    fmt = struct.pack("<HHIIHH", 3, 2, 48000, 48000 * 16, 16, 64)
    p = tmp_path / "f64.wav"
    p.write_bytes(_wav_bytes(fmt, f64.tobytes()))
    s, rate, ch = read_wav(p)
    assert (rate, ch) == (48000, 2)
    np.testing.assert_array_equal(s, f64.astype(np.float32))


def test_wav_extensible_resolves_subformat(tmp_path):
    """WAVE_FORMAT_EXTENSIBLE (0xFFFE) resolves to its SubFormat code."""
    import struct

    i16 = np.array([100, -100, 32767, -32768], "<i2")
    # extensible fmt: base fields + cbSize=22 + validbits + mask + GUID
    fmt = (struct.pack("<HHIIHH", 0xFFFE, 2, 44100, 44100 * 4, 4, 16)
           + struct.pack("<HHI", 22, 16, 3)
           + struct.pack("<H", 1)  # SubFormat code = PCM
           + b"\x00" * 14)
    p = tmp_path / "ext.wav"
    p.write_bytes(_wav_bytes(fmt, i16.tobytes()))
    from glc.io.wav import read_wav, read_wav_pcm16

    s, rate, ch = read_wav(p)
    assert (rate, ch) == (44100, 2)
    np.testing.assert_array_equal(s, i16 / np.float32(32768.0))
    # the exact i16 fast path must also resolve the extensible SubFormat
    fast = read_wav_pcm16(p)
    assert fast is not None
    pcm, rate, ch = fast
    assert (rate, ch) == (44100, 2)
    np.testing.assert_array_equal(pcm, i16)
