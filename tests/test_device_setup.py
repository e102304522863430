"""What decides how the program meets the device: the compile-cache
placement, the transform precision against a float64 reference, the
encoder's batch cap, and the scripts that refuse to run without a GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from glc.codec.encoder import batch_bytes_cap
from glc.ops.mdct import (
    get_mdct_tables,
    imdct,
    imdct_window_f64,
    mdct,
    mdct_f64,
    relative_error,
)

ROOT = Path(__file__).resolve().parent.parent


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(extra)
    return env


@pytest.mark.parametrize("case", ["env_set", "checkout_default", "cpu"])
def test_compile_cache_placement(case, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set → the package names no other
    directory; unset in a checkout → <checkout>/.jax_cache; an explicitly
    CPU process → no cache."""
    env, want = {
        "env_set": (dict(JAX_COMPILATION_CACHE_DIR=str(tmp_path),
                         JAX_PLATFORMS=""), str(tmp_path)),
        "checkout_default": (dict(JAX_PLATFORMS=""),
                             str(ROOT / ".jax_cache")),
        "cpu": (dict(JAX_PLATFORMS="cpu"), None),
    }[case]
    p = subprocess.run(
        [sys.executable, "-c",
         "import json, glc, jax; "
         "print(json.dumps(jax.config.jax_compilation_cache_dir))"],
        cwd=ROOT, env=_child_env(**env), capture_output=True, text=True,
        timeout=120,
    )
    assert p.returncode == 0, p.stderr[-800:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == want


@pytest.mark.parametrize("frames", [2816, 4096])
@pytest.mark.parametrize("transform", ["mdct", "imdct_window"])
def test_transform_matches_float64(transform, frames):
    """The plain transforms at the encode-segment and decode-chunk widths
    (frames × 2 channels) stay within 1e-5 of float64 NumPy.  chip_smoke.py
    holds the card to the same bound, which TF32 products would miss."""
    tb = get_mdct_tables(1024, 2048)
    rng = np.random.default_rng(frames)
    if transform == "mdct":
        x = rng.standard_normal((frames, 2, 2048)).astype(np.float32)
        out = mdct(x, tb.cos_table, tb.norm)
        ref = mdct_f64(x, tb)
    else:
        x = rng.standard_normal((frames, 2, 1024)).astype(np.float32) * 0.1
        out = imdct(x, tb.cos_table, tb.norm) * tb.window
        ref = imdct_window_f64(x, tb)
    assert out.shape == ref.shape
    assert relative_error(out, ref) <= 1e-5


@pytest.mark.parametrize("stats, want", [
    (None, 2 << 30),
    ({}, 2 << 30),
    ({"bytes_limit": 60_129_542_144}, 60_129_542_144 // 8),
])
def test_batch_cap_rule(stats, want):
    """One eighth of the device's bytes_limit; a fixed 2 GiB where the
    backend reports none (the CPU)."""
    assert batch_bytes_cap(stats) == want


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_without_gpu(script):
    """Without a GPU both scripts exit non-zero before any work and print
    no result line."""
    p = subprocess.run(
        [sys.executable, script], cwd=ROOT,
        env=_child_env(JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=120,
    )
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert '"metric"' not in p.stdout
    assert "GPU" in p.stderr
