"""Micro-benchmarks + codec analytics (mirrors reference
tests/test_micro_benchmark.rs — printed, assertion-light).

The reference notes private functions can't be benchmarked directly
(test_micro_benchmark.rs:1-11); our kernels are public device functions by
design, so each stage is separately timeable.
"""

import time

import jax
import numpy as np

from glc import Encoder
from glc.codec.tables import get_device_tables
from glc.ops.encode import encode_chunk_device
from glc.ops.mdct import get_mdct_tables, mdct
from utils import (
    generate_frequency_sweep,
    generate_sine_wave,
    generate_square_wave,
    generate_white_noise,
)


def test_mdct_cost():
    """Approximate per-frame MDCT cost on the batched path."""
    t = get_mdct_tables(1024, 2048)
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((512, 2048)).astype(np.float32)
    f = jax.jit(lambda b: mdct(b, t.cos_table, t.norm))
    f(blocks).block_until_ready()
    t0 = time.perf_counter()
    f(blocks).block_until_ready()
    dt = time.perf_counter() - t0
    print(f"MDCT 512 frames: {dt*1000:.2f} ms "
          f"({dt/512*1e6:.1f} µs/frame)")


def test_full_stage_cost():
    """Window+MDCT+mask+quantize for one chunk."""
    tb = get_device_tables(1024, 2048, 44100)
    rng = np.random.default_rng(1)
    blocks = rng.standard_normal((128, 2, 2048)).astype(np.float32) * 0.1
    args = (blocks, tb.cos_table, tb.window, tb.norm, tb.band_mask,
            tb.band_inv_count, tb.band_pf, tb.band_of, tb.inv_w)
    jax.block_until_ready(encode_chunk_device(*args))
    t0 = time.perf_counter()
    jax.block_until_ready(encode_chunk_device(*args))
    dt = time.perf_counter() - t0
    print(f"encode chunk 128×2ch: {dt*1000:.2f} ms "
          f"({dt/256*1e6:.1f} µs/frame-channel)")


def test_sparsity_by_signal_type():
    """Coefficient retention per signal class
    (test_micro_benchmark.rs:205-247)."""
    enc = Encoder(44100)
    rows = []
    for name, sig in [
        ("sine", generate_sine_wave(440.0, 44100, 1, 1.0)),
        ("square", generate_square_wave(440.0, 44100, 1, 1.0)),
        ("sweep", generate_frequency_sweep(100.0, 8000.0, 44100, 1, 1.0)),
        ("noise", generate_white_noise(44100, 1, 1.0, 5)),
    ]:
        encoded = enc.encode(sig, 1)
        fs = encoded.frame_set
        comp = int((~fs.raw_mask).sum())
        raw = int(fs.raw_mask.sum())
        nnz = int(fs.nnz.sum())
        pct = 100.0 * nnz / max(comp * 1024, 1)
        rows.append((name, comp, raw, pct))
        print(f"{name:7s}: {comp} compressed frames, {raw} raw frames, "
              f"{pct:.1f}% coefficients kept")
    # tonal content keeps far fewer coefficients than noise keeps frames
    assert rows[0][3] < 50.0       # sine sparse
    assert rows[3][2] > 0          # noise falls back to raw
