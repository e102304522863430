"""Multi-device sharding tests on a virtual 8-device CPU mesh.

The analog of the reference's rayon thread-scaling tests
(reference tests/test_performance.rs:134-156): the same math must produce
the same results when the frame axis is sharded across devices, with the
OLA halo exchanged via ppermute.
"""

import jax
import numpy as np
import pytest

from glc.codec.tables import get_device_tables
from glc.ops.decode import decode_chunk_device
from glc.ops.encode import encode_chunk_device
from glc.parallel import (
    decode_chunk_sharded,
    encode_chunk_sharded,
    make_mesh,
    roundtrip_step_sharded,
)


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (conftest gives the CPU backend 8)")


pytestmark = pytest.mark.usefixtures("eight_devices")


@pytest.fixture(scope="module")
def tables():
    return get_device_tables(1024, 2048, 44100)


def _random_blocks(B, K, C, rng):
    return rng.standard_normal((B, K, C, 2048), np.float32) * 0.1


def test_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.shape == {"data": 2, "frames": 4}
    mesh1 = make_mesh(2)
    assert mesh1.shape == {"data": 1, "frames": 2}


def test_sharded_encode_matches_single_device(tables):
    rng = np.random.default_rng(0)
    blocks = _random_blocks(2, 8, 2, rng)
    mesh = make_mesh(8)

    q_s, nnz_s, scale_s, raw_s, use_raw_s = encode_chunk_sharded(
        mesh, blocks, tables
    )

    # single-device reference: flatten the stream axis
    q_r, nnz_r, scale_r, raw_r, use_raw_r = encode_chunk_device(
        blocks.reshape(-1, 2, 2048),
        *[getattr(tables, f) for f in tables._fields],
    )
    np.testing.assert_array_equal(np.asarray(q_s).reshape(-1, 2, 1024), q_r)
    np.testing.assert_array_equal(np.asarray(nnz_s).reshape(-1, 2), nnz_r)
    np.testing.assert_allclose(
        np.asarray(scale_s).reshape(-1, 2), scale_r, rtol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(use_raw_s).reshape(-1), use_raw_r
    )


def test_sharded_decode_matches_single_device(tables):
    rng = np.random.default_rng(1)
    B, K, C, n = 2, 8, 2, 1024
    q = rng.integers(-2000, 2000, (B, K, C, n)).astype(np.int16)
    scales = rng.random((B, K, C)).astype(np.float32) + 0.1
    raw = np.zeros((B, K, C, 2048), np.int16)
    is_raw = np.zeros((B, K), bool)
    is_raw[:, 3] = True
    raw[:, 3] = rng.integers(-3000, 3000, (B, C, 2048)).astype(np.int16)
    carry = rng.standard_normal((B, C, n)).astype(np.float32)

    mesh = make_mesh(8)
    hops_s, tail_s = decode_chunk_sharded(
        mesh, q, scales, raw, is_raw, carry, tables
    )

    for b in range(B):
        hops_r, tail_r = decode_chunk_device(
            q[b], scales[b], raw[b], is_raw[b], carry[b], np.int32(K),
            tables.cos_table, tables.window, tables.norm,
        )
        np.testing.assert_allclose(
            np.asarray(hops_s)[b], np.asarray(hops_r), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(tail_s)[b], np.asarray(tail_r), atol=1e-5
        )


def test_roundtrip_step_runs(tables):
    rng = np.random.default_rng(2)
    blocks = _random_blocks(2, 8, 1, rng)
    carry = np.zeros((2, 1, 1024), np.float32)
    mesh = make_mesh(8)
    mse, hops = roundtrip_step_sharded(mesh, blocks, carry, tables)
    mse = float(mse)
    assert np.isfinite(mse)
    assert np.asarray(hops).shape == (2, 8, 1, 1024)


def _graft_entry():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__

    return __graft_entry__


def test_graft_entry_and_dryrun():
    """entry() compiles on one device; dryrun_multichip compiles and
    executes the sharded step on the virtual mesh."""
    g = _graft_entry()

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    q, nnz, scales, raw, use_raw = out
    assert q.shape == (128, 2, 1024)
    assert use_raw.shape == (128,)
    g.dryrun_multichip(8)


def test_dryrun_refuses_missing_devices():
    """Asking for more devices than exist raises instead of falling back."""
    with pytest.raises(ValueError, match="only 8 present"):
        _graft_entry().dryrun_multichip(16)


def test_check_mesh_on_four_devices():
    """The mesh check that chip_smoke.py --four-cards runs, on 4 virtual
    CPU devices: the (2, 2) mesh, bit-identical encode, ≤1-ulp decode."""
    from utils import generate_sine_wave, generate_white_noise

    from glc.parallel import check_mesh

    album = [
        generate_sine_wave(440.0, 44100, 2, 0.4),
        generate_white_noise(44100, 2, 0.1, 5) * np.float32(0.5),
    ]
    res = check_mesh(4, album)
    assert res["mesh"] == {"data": 2, "frames": 2}
    assert res["tracks"] == 2 and res["encode_bit_identical"]
    assert np.isfinite(res["roundtrip_mse"])
