"""Pure FLAC encoder (RFC 9639 subset) + independent FLAC decoder.

Mirrors the reference's hand-written encoder (reference src/flac.rs): fixed
predictors only, independent channels, 16-bit, levels 0-8 differing in block
size / predictor order / partition order (SURVEY.md Q7).  The numeric parts
(fixed-predictor residuals, Rice parameter estimation) run as a native
single-pass kernel on the host, with a batched JAX twin; bit packing, CRCs and headers are native C++ (native/glc_native.cpp)
with a pure-Python fallback.
"""

from .encoder import (
    encode_flac,
    encode_flac_with_level,
    export_to_flac,
    export_to_flac_with_level,
)
from .decoder import decode_flac, read_flac

__all__ = [
    "encode_flac",
    "encode_flac_with_level",
    "export_to_flac",
    "export_to_flac_with_level",
    "decode_flac",
    "read_flac",
]
