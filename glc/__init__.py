"""glc — gapless lossy audio codec on an accelerator (JAX/XLA).

A from-scratch JAX/XLA rebuild of the `gapless-lossy-codec` Rust crate
(the reference, surveyed in SURVEY.md).  The public API mirrors the reference
library facade (reference src/lib.rs:1-5 re-exports `codec::*` and the
`audio`/`flac` modules):

    from glc import Encoder, Decoder, save_encoded, load_encoded
    from glc import audio, flac

Compute path (MDCT / psychoacoustic masking / quantization / IMDCT /
overlap-add) runs on the accelerator as batched XLA programs over a
frame-major layout; bit-exact container and
bitstream writers run on host (numpy vectorized + native C++).
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache: CLI invocations are separate processes,
# and each would otherwise compile every program shape again.  Where
# JAX_COMPILATION_CACHE_DIR is set, JAX keeps the cache there on its own and
# this package names no other directory.  Otherwise a checkout (recognised by
# the pyproject.toml beside the package) keeps it at <checkout>/.jax_cache.
# Not for an explicitly CPU process: XLA:CPU artifacts are pinned to the
# host's CPU features, and the test suite runs on the CPU.
_pkg_parent = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
_in_checkout = _os.path.isfile(_os.path.join(_pkg_parent, "pyproject.toml"))
if _os.environ.get("JAX_PLATFORMS", "").lower() != "cpu":
    if "JAX_COMPILATION_CACHE_DIR" not in _os.environ and _in_checkout:
        _jax.config.update(
            "jax_compilation_cache_dir", _os.path.join(_pkg_parent, ".jax_cache")
        )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .config import CodecConfig, DEFAULT_CONFIG
from .container.schema import (
    AudioHeader,
    GaplessInfo,
    EncodedFrame,
    EncodedAudio,
    Progress,
    AudioChunk,
)
from .container.bincode import save_encoded, load_encoded, serialize_encoded, deserialize_encoded
from .codec.encoder import Encoder
from .codec.decoder import Decoder
from .warmup import warmup

__version__ = "0.5.0"

__all__ = [
    "CodecConfig",
    "DEFAULT_CONFIG",
    "AudioHeader",
    "GaplessInfo",
    "EncodedFrame",
    "EncodedAudio",
    "Progress",
    "AudioChunk",
    "save_encoded",
    "load_encoded",
    "serialize_encoded",
    "deserialize_encoded",
    "Encoder",
    "Decoder",
    "warmup",
]
