"""Program-ladder warmup: pre-compile the shipped device programs.

A fresh process pays XLA compilation for every (shape-bucket, budget-tier)
program the pipelines dispatch when the persistent cache (placed by
``glc/__init__.py``) is cold.  ``warmup()`` round-trips a few seconds-to-minutes of synthetic
program-like material through the EXACT shipped entry points
(``Encoder.encode_pcm16``, ``Decoder.decode_i16``, the streaming FLAC
export), so every program those paths dispatch is compiled once and lands
in the persistent cache; subsequent processes (a CLI invocation, a driver
bench run) load it in milliseconds.

The warm signal must look like program material, not silence: the encode
transfer programs are BUDGET-TIERED by measured coefficient density
(glc/codec/encoder.py::_pick_budget), so silence would warm the wrong
tier.  The chord+sweep+noise mix below lands in the same n/8 tier as
typical music.
"""

from __future__ import annotations

import numpy as np


def _program_material(seconds: float, sample_rate: int,
                      channels: int) -> np.ndarray:
    t = np.arange(int(sample_rate * seconds), dtype=np.float32) / sample_rate
    left = (
        0.30 * np.sin(2 * np.pi * 261.63 * t)
        + 0.20 * np.sin(2 * np.pi * 329.63 * t)
        + 0.15 * np.sin(2 * np.pi * (440.0 + 100.0 * t) * t)
    )
    rng = np.random.default_rng(99)
    noise = rng.standard_normal(len(t)).astype(np.float32) * 0.01
    chans = [left + noise] + [left * 0.9 + noise] * (channels - 1)
    out = np.empty(channels * len(t), np.float32)
    for c, x in enumerate(chans):
        out[c::channels] = x
    return np.clip(out * 32767.0, -32768, 32767).astype(np.int16)


def warmup(sample_rate: int = 44100, channels: int = 2,
           seconds: float = 60.0, flac: bool = True,
           config=None) -> None:
    """Compile (or cache-load) the shipped program ladder for one
    (sample_rate, channels) deployment class.

    ``seconds`` picks the shape class: ≥ ~33 s covers the full-size
    4096-frame encode segment and 1408-frame decode chunk programs that
    long files dispatch; smaller values warm only the short-file buckets.
    One call costs one encode + decode (+ FLAC export) of that much audio
    — seconds when the persistent cache is warm, a few minutes of compiles
    the very first time on a fresh machine.
    """
    from .codec.decoder import Decoder
    from .codec.encoder import Encoder

    enc = Encoder(sample_rate, config=config)
    dec = Decoder(channels, sample_rate, config=config)
    pcm = _program_material(seconds, sample_rate, channels)
    encoded = enc.encode_pcm16(pcm, channels)
    dec.decode_i16(encoded)
    if flac:
        from .flac.encoder import encode_flac_i16_streaming

        n_total = dec.decoded_length(encoded)
        encode_flac_i16_streaming(
            dec.decode_i16_stream(encoded),
            sample_rate, channels, 5, n_total // channels,
        )
