"""CLI behavior tests (mirrors reference src/main.rs flag/exit-code
semantics).  Drives `glc.cli.main` in-process to avoid per-test JAX
startup cost."""

import numpy as np
import pytest

from glc.cli import main
from glc.io.wav import read_wav, write_wav
from utils import generate_sine_wave


@pytest.fixture
def wav_file(tmp_path):
    samples = generate_sine_wave(440.0, 44100, 1, 1.0)
    p = tmp_path / "tone.wav"
    write_wav(p, samples, 44100, 1)
    return p


def test_encode_creates_glc(wav_file, capsys):
    assert main([str(wav_file)]) == 0
    glc = wav_file.with_suffix(".glc")
    assert glc.exists()
    out = capsys.readouterr().out
    assert "Loading:" in out and "Encoding:" in out and "Saved:" in out
    assert "% of original" in out


def test_decode_default_flac(wav_file, capsys):
    main([str(wav_file)])
    glc = wav_file.with_suffix(".glc")
    assert main(["-d", str(glc)]) == 0
    flac = wav_file.with_suffix(".flac")
    assert flac.exists()
    assert flac.read_bytes()[:4] == b"fLaC"
    assert "(FLAC, level 5)" in capsys.readouterr().out


def test_decode_wav_flag(wav_file):
    main([str(wav_file)])
    glc = wav_file.with_suffix(".glc")
    # decode to WAV; output overwrites the original .wav path (same stem,
    # same as the reference's set_extension behavior)
    assert main(["-d", str(glc), "--wav"]) == 0
    out_wav = wav_file.with_suffix(".wav")
    samples, rate, channels = read_wav(out_wav)
    assert (rate, channels) == (44100, 1)
    assert len(samples) == 44100


def test_decode_flac_level_flag(wav_file):
    main([str(wav_file)])
    glc = wav_file.with_suffix(".glc")
    assert main(["-d", str(glc), "--flac-level", "8"]) == 0
    assert wav_file.with_suffix(".flac").exists()


def test_decode_invalid_level(wav_file):
    main([str(wav_file)])
    glc = wav_file.with_suffix(".glc")
    assert main(["-d", str(glc), "--flac-level", "9"]) == 1
    assert main(["-d", str(glc), "--flac-level", "x"]) == 1
    assert main(["-d", str(glc), "--flac-level"]) == 1


def test_decode_missing_file(tmp_path):
    assert main(["-d", str(tmp_path / "missing.glc")]) == 1


def test_decode_wrong_extension(wav_file):
    assert main(["-d", str(wav_file)]) == 1


def test_decode_no_args():
    assert main(["-d"]) == 1


def test_encode_missing_file(tmp_path):
    assert main([str(tmp_path / "missing.wav")]) == 1


def test_encode_unsupported_type(tmp_path):
    p = tmp_path / "x.mp3"
    p.write_bytes(b"junk")
    assert main([str(p)]) == 1


def test_encode_continue_on_error(wav_file, tmp_path):
    """main.rs:545-583 — one bad file does not stop the batch, but the exit
    code is 1."""
    missing = tmp_path / "missing.wav"
    assert main([str(missing), str(wav_file)]) == 1
    assert wav_file.with_suffix(".glc").exists()


def test_encode_flac_input(tmp_path):
    """FLAC input → .glc (the claxon-load path, audio.rs:66-83)."""
    from glc.flac.encoder import export_to_flac
    samples = generate_sine_wave(440.0, 44100, 2, 0.5)
    p = tmp_path / "in.flac"
    export_to_flac(p, samples, 44100, 2)
    assert main([str(p)]) == 0
    assert (tmp_path / "in.glc").exists()


def test_play_no_args():
    assert main(["-p"]) == 1


def test_play_missing_file(tmp_path):
    assert main(["-p", str(tmp_path / "x.glc")]) == 1


def test_encode_float_wav_input(tmp_path):
    """Float32 WAVs take the f32 (non-pcm16) encode path."""
    import struct
    from utils import generate_sine_wave
    samples = generate_sine_wave(440.0, 44100, 1, 0.5)
    payload = samples.astype("<f4").tobytes()
    header = b"".join([
        b"RIFF", struct.pack("<I", 36 + len(payload)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 3, 1, 44100, 44100 * 4, 4, 32),
        b"data", struct.pack("<I", len(payload)),
    ])
    p = tmp_path / "f32.wav"
    p.write_bytes(header + payload)
    assert main([str(p)]) == 0
    assert (tmp_path / "f32.glc").exists()


def test_gui_module_importable():
    """ui.py must import cleanly (it only touches tkinter inside run_gui)."""
    import glc.ui
    assert hasattr(glc.ui, "run_gui")


def test_play_without_audio_backend(wav_file):
    """-p with no ffplay in PATH → reference-style error + exit 1
    (main.rs:181-198 stub semantics)."""
    from glc.playback import ffplay_available
    if ffplay_available():
        import pytest
        pytest.skip("ffplay present; cannot exercise the no-backend path")
    main([str(wav_file)])
    glc = wav_file.with_suffix(".glc")
    assert main(["-p", str(glc)]) == 1


def test_cli_multi_file_encode_batched_matches_single(tmp_path, capsys):
    """Multi-file encode batches through encode_many; the .glc bytes must be
    bit-identical to single-file invocations, messages unchanged, and a bad
    file mid-list still isolates (exit 1, good files encoded) —
    main.rs:545-583 semantics at batch speed."""
    import numpy as np

    from glc.cli import main
    from glc.io.wav import write_wav

    rng = np.random.default_rng(0)
    wavs = []
    for i, f in enumerate((440.0, 550.0, 660.0)):
        t = np.arange(22050, dtype=np.float32) / 44100.0
        mono = (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)
        s = np.repeat(mono, 2)
        p = tmp_path / f"m{i}.wav"
        write_wav(p, s, 44100, 2)
        wavs.append(p)

    # single-file oracle bytes
    singles = []
    for p in wavs:
        assert main([str(p)]) == 0
        singles.append(p.with_suffix(".glc").read_bytes())
        p.with_suffix(".glc").unlink()
    capsys.readouterr()

    # batched multi-file run
    assert main([str(p) for p in wavs]) == 0
    out = capsys.readouterr().out
    for p, ref in zip(wavs, singles):
        assert p.with_suffix(".glc").read_bytes() == ref
        assert f"Loading: {p.name!r}" in out
        assert f"Saved: {p.with_suffix('.glc').name!r}" in out

    # continue-on-error: a missing file mid-list → exit 1, others encoded
    for p in wavs:
        p.with_suffix(".glc").unlink()
    args = [str(wavs[0]), str(tmp_path / "missing.wav"), str(wavs[2])]
    assert main(args) == 1
    assert wavs[0].with_suffix(".glc").read_bytes() == singles[0]
    assert wavs[2].with_suffix(".glc").read_bytes() == singles[2]
