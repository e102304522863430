"""Timing tests (mirrors reference tests/test_performance.rs — printed
measurements of the CPU backend, not device numbers).

The reference's rayon 1/2/4/8-thread scaling becomes mesh-shard scaling on
the virtual CPU device mesh.  GPU numbers come from bench.py.
"""

import time

import numpy as np
import pytest

from glc import Decoder, Encoder
from utils import generate_sine_wave, generate_square_wave


def test_encoder_construction_cost():
    """test_performance.rs: encoder construction ×N (table warmup is cached
    after the first)."""
    t0 = time.perf_counter()
    Encoder(44100)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(100):
        Encoder(44100)
    rest = (time.perf_counter() - t0) / 100
    print(f"Encoder construction: first {first*1000:.1f} ms, "
          f"cached {rest*1e6:.1f} µs")
    assert rest < first + 1.0


def test_encode_speed_by_duration():
    enc = Encoder(44100)
    for duration in (0.5, 1.0, 2.0):
        samples = generate_sine_wave(440.0, 44100, 1, duration)
        enc.encode(samples, 1)  # warm compile for this shape bucket
        t0 = time.perf_counter()
        enc.encode(samples, 1)
        dt = time.perf_counter() - t0
        print(f"encode {duration:.1f}s mono: {dt*1000:.1f} ms "
              f"({duration/dt:.1f}x realtime)")


def test_waveform_complexity():
    enc = Encoder(44100)
    for name, samples in [
        ("sine", generate_sine_wave(440.0, 44100, 1, 1.0)),
        ("square", generate_square_wave(440.0, 44100, 1, 1.0)),
    ]:
        enc.encode(samples, 1)
        t0 = time.perf_counter()
        encoded = enc.encode(samples, 1)
        dt = time.perf_counter() - t0
        nnz = int(encoded.frame_set.nnz.sum())
        print(f"{name}: {dt*1000:.1f} ms, {nnz} coefficients kept")


def test_stereo_vs_mono():
    enc = Encoder(44100)
    mono = generate_sine_wave(440.0, 44100, 1, 1.0)
    stereo = generate_sine_wave(440.0, 44100, 2, 1.0)
    enc.encode(mono, 1)
    enc.encode(stereo, 2)
    t0 = time.perf_counter(); enc.encode(mono, 1)
    t_mono = time.perf_counter() - t0
    t0 = time.perf_counter(); enc.encode(stereo, 2)
    t_stereo = time.perf_counter() - t0
    print(f"mono {t_mono*1000:.1f} ms, stereo {t_stereo*1000:.1f} ms, "
          f"ratio {t_stereo/max(t_mono,1e-9):.2f}")


def test_decode_speed_and_roundtrip():
    samples = generate_sine_wave(440.0, 44100, 1, 2.0)
    enc = Encoder(44100)
    encoded = enc.encode(samples, 1)
    dec = Decoder(1, 44100)
    dec.decode(encoded)  # warm
    t0 = time.perf_counter()
    out = dec.decode(encoded)
    dt = time.perf_counter() - t0
    print(f"decode 2s mono: {dt*1000:.1f} ms ({2.0/dt:.1f}x realtime)")
    assert len(out) == len(samples)


def test_mesh_scaling():
    """The rayon-thread-scaling analog: sharded encode on 1/2/4/8 virtual
    devices (test_performance.rs:134-156)."""
    import jax

    from glc.codec.tables import get_device_tables
    from glc.parallel import encode_chunk_sharded, make_mesh

    if len(jax.devices()) < 8:
        print("skipping: <8 devices")
        return
    tables = get_device_tables(1024, 2048, 44100)
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((2, 64, 2, 2048)).astype(np.float32) * 0.1
    for n in (1, 2, 4, 8):
        mesh = make_mesh(n)
        encode_chunk_sharded(mesh, blocks, tables)  # warm
        t0 = time.perf_counter()
        out = encode_chunk_sharded(mesh, blocks, tables)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        print(f"mesh {dict(mesh.shape)}: {dt*1000:.1f} ms")


def test_encode_many_pipelining():
    """Pipelined multi-file encode vs serial (print-only, like the
    reference's thread-scaling prints — the ratio depends on whether the
    link and device overlap in this environment)."""
    tracks = [(generate_sine_wave(440.0 + 110.0 * i, 44100, 2, 1.0), 2)
              for i in range(4)]
    enc = Encoder(44100)
    enc.encode_many(tracks)  # warm
    t0 = time.perf_counter()
    enc.encode_many(tracks)
    dt_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s, c in tracks:
        enc.encode(s, c)
    dt_serial = time.perf_counter() - t0
    print(f"encode_many 4x1s stereo: batched {dt_many*1000:.1f} ms vs "
          f"serial {dt_serial*1000:.1f} ms ({dt_serial/dt_many:.2f}x)")


def test_streaming_export_timing():
    """decode→FLAC streamed vs batch (print-only)."""
    from glc.flac.encoder import (
        encode_flac_i16_streaming,
        encode_flac_i16_with_level,
    )

    samples = generate_sine_wave(440.0, 44100, 2, 2.0)
    enc = Encoder(44100)
    encoded = enc.encode(samples, 2)
    dec = Decoder(2, 44100)
    n_total = dec.decoded_length(encoded)
    # warm both
    encode_flac_i16_streaming(dec.decode_i16_stream(encoded), 44100, 2, 5,
                              n_total // 2)
    encode_flac_i16_with_level(dec.decode_i16(encoded), 44100, 2, 5)
    t0 = time.perf_counter()
    a = encode_flac_i16_streaming(dec.decode_i16_stream(encoded), 44100, 2,
                                  5, n_total // 2)
    dt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = encode_flac_i16_with_level(dec.decode_i16(encoded), 44100, 2, 5)
    dt_b = time.perf_counter() - t0
    assert a == b
    print(f"decode+flac 2s stereo: streamed {dt_s*1000:.1f} ms vs batch "
          f"{dt_b*1000:.1f} ms")


def test_warmup_compiles_shipped_paths():
    """glc.warmup() must run the exact shipped entry points without
    error at a small shape class (CPU compiles of the full-size 4096-frame
    programs are too slow for the test suite)."""
    import glc

    glc.warmup(seconds=1.0, channels=2, flac=True)
    glc.warmup(seconds=0.5, channels=1, flac=False)
