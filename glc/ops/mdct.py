"""MDCT/IMDCT as batched matmuls against a precomputed cosine table.

The reference computes the MDCT as naive O(N·2N) dot products against a
precomputed table (reference src/codec.rs:313-391).  Here that table is one
batched matmul `frames @ table.T` (and IMDCT `coeffs @ table`) at
Precision.HIGHEST, which keeps the f32 products exact on the GPU (no TF32).

Table math matches the reference's f32 evaluation order bit-for-bit:
  angle = (PI/n) * (i + 0.5 + n/2) * (k + 0.5)      (codec.rs:335, f32, left-assoc)
  window = sin(PI * (i + 0.5) / 2N)                  (codec.rs:342-344)
  norm   = sqrt(2/n)                                 (codec.rs:347)
with cos/sin evaluated correctly-rounded (f64 eval of the f32 angle, cast back).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


@dataclass(frozen=True)
class MdctTables:
    """Precomputed tables (reference src/codec.rs:326-356)."""

    cos_table: np.ndarray  # [n, frame_size] f32
    window: np.ndarray     # [frame_size] f32
    n: int                 # hop size / number of coefficients
    norm: np.float32       # sqrt(2/n)

    def __hash__(self):
        return hash((self.n, self.cos_table.shape))


@lru_cache(maxsize=8)
def get_mdct_tables(n: int = 1024, frame_size: int = 2048) -> MdctTables:
    pi = np.float32(np.pi)
    nf = np.float32(n)
    i = np.arange(frame_size, dtype=np.float32)
    k = np.arange(n, dtype=np.float32)

    # ((PI / n) * (i + 0.5 + n/2)) * (k + 0.5), all f32, matching Rust
    # left-to-right association (codec.rs:335).
    t1 = (pi / nf) * (i + np.float32(0.5) + nf / np.float32(2.0))  # [frame_size]
    angle = t1[None, :] * (k[:, None] + np.float32(0.5))
    cos_table = np.cos(angle.astype(np.float64)).astype(np.float32)

    w_angle = (pi * (i + np.float32(0.5))) / np.float32(frame_size)
    window = np.sin(w_angle.astype(np.float64)).astype(np.float32)

    norm = np.sqrt(np.float32(2.0) / nf).astype(np.float32)
    return MdctTables(cos_table=cos_table, window=window, n=n, norm=norm)


def mdct(blocks: jnp.ndarray, cos_table: jnp.ndarray, norm) -> jnp.ndarray:
    """Batched MDCT: [..., frame_size] -> [..., n] (codec.rs:358-374).

    One matmul; `norm` applied to the result exactly as the reference
    applies it to each dot product.
    """
    coeffs = jnp.einsum("...t,nt->...n", blocks, cos_table, precision=HIGHEST)
    return coeffs * norm


def imdct(coeffs: jnp.ndarray, cos_table: jnp.ndarray, norm) -> jnp.ndarray:
    """Batched IMDCT: [..., n] -> [..., frame_size] (codec.rs:376-391)."""
    out = jnp.einsum("...n,nt->...t", coeffs, cos_table, precision=HIGHEST)
    return out * norm


def mdct_f64(blocks: np.ndarray, tables: MdctTables) -> np.ndarray:
    """Plain float64 NumPy MDCT of the same tables — the reference the
    device transform is held to."""
    return (np.asarray(blocks, np.float64)
            @ tables.cos_table.T.astype(np.float64)) * float(tables.norm)


def imdct_window_f64(coeffs: np.ndarray, tables: MdctTables) -> np.ndarray:
    """Plain float64 NumPy IMDCT followed by the synthesis window."""
    out = (np.asarray(coeffs, np.float64)
           @ tables.cos_table.astype(np.float64)) * float(tables.norm)
    return out * tables.window.astype(np.float64)


def relative_error(out, ref: np.ndarray) -> float:
    """max |out − ref| over max |ref|: one number per transform output.
    f32 products at Precision.HIGHEST land near 1e-6; TF32 near 1e-3."""
    out = np.asarray(out, np.float64)
    return float(np.abs(out - ref).max() / np.abs(ref).max())
