"""Album-level operations: gapless playlist decode and concatenated export.

Library form of the GUI's "gapless album join" (reference src/ui.rs:291-402):
decode every .glc in order, concatenate the trimmed streams, export one
lossless file.  The per-file trims make the concatenation sample-exact at
track boundaries — the gapless contract (reference tests/test_codec.rs:139-170).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np

from .codec.decoder import Decoder
from .container.bincode import load_encoded
from .container.schema import Progress


def decode_playlist(
    paths: Sequence[Union[str, Path]],
    progress: Optional[Callable[[Progress], None]] = None,
):
    """Decode a playlist to one concatenated int16 stream.

    Returns (samples int16 interleaved, sample_rate, channels).  All files
    must share a sample rate and channel count (ui.rs decodes them into one
    sink; mismatched playlists are an error here rather than silent
    resampling).

    Path dependence (±1 LSB): with progress=None, same-bucket tracks route
    through the batched `decode_many`, whose lax.map program XLA may fuse
    differently from the serial `decode_i16` used when a progress callback
    is given — so the same playlist can differ by ≤1 int16 LSB between
    interactive and non-interactive callers (the same contract as every
    other cross-program pair; tests pin the bound).
    """
    if not paths:
        raise ValueError("empty playlist")
    encodeds = []
    rate = channels = None
    for path in map(Path, paths):
        encoded = load_encoded(path)
        h = encoded.header
        if rate is None:
            rate, channels = h.sample_rate, h.channels
        elif (h.sample_rate, h.channels) != (rate, channels):
            raise ValueError(
                f"{path.name}: {h.sample_rate} Hz/{h.channels}ch does not "
                f"match playlist {rate} Hz/{channels}ch"
            )
        encodeds.append((Path(path), encoded))

    dec = Decoder(channels, rate)
    if progress is None:
        # same-bucket tracks decode through ONE batched device program
        parts = dec.decode_many([ea for _p, ea in encodeds])
    else:
        # an interactive consumer wants per-track movement — keep the
        # serial path so status/percent advance as each track decodes
        parts = []
        for i, (path, ea) in enumerate(encodeds):
            progress(Progress.status(f"Decoding {path.name}"))
            parts.append(dec.decode_i16(ea))
            progress(Progress.decoding((i + 1) / len(encodeds) * 100.0))
    return np.concatenate(parts), rate, channels


def export_playlist_to_flac(
    paths: Sequence[Union[str, Path]],
    out_path: Union[str, Path],
    compression_level: int = 5,
    progress: Optional[Callable[[Progress], None]] = None,
) -> None:
    """ui.rs:291-402 — decode all, concatenate, single FLAC export.

    Streams each track's decoded chunks straight into the FLAC encoder, so
    the host-side MD5/predictor/Rice work overlaps the device decode's
    transfers (byte-identical to decode-everything-then-encode).
    """
    from .codec.decoder import Decoder
    from .flac.encoder import encode_flac_i16_streaming

    if not paths:
        raise ValueError("empty playlist")
    encodeds = []
    rate = channels = None
    for path in map(Path, paths):
        encoded = load_encoded(path)
        h = encoded.header
        if rate is None:
            rate, channels = h.sample_rate, h.channels
        elif (h.sample_rate, h.channels) != (rate, channels):
            raise ValueError(
                f"{path.name}: {h.sample_rate} Hz/{h.channels}ch does not "
                f"match playlist {rate} Hz/{channels}ch"
            )
        encodeds.append((path, encoded))

    dec = Decoder(channels, rate)
    total = sum(dec.decoded_length(ea) for _, ea in encodeds)

    def chunks():
        for i, (path, ea) in enumerate(encodeds):
            if progress:
                progress(Progress.status(f"Decoding {path.name}"))
            yield from dec.decode_i16_stream(ea)
            if progress:
                progress(Progress.decoding((i + 1) / len(encodeds) * 100.0))

    data = encode_flac_i16_streaming(chunks(), rate, channels,
                                     compression_level, total // channels)
    if progress:
        progress(Progress.exporting(90.0))
    Path(out_path).write_bytes(data)
    if progress:
        progress(Progress.complete(f"Exported {len(paths)} tracks"))


def export_playlist_to_wav(
    paths: Sequence[Union[str, Path]],
    out_path: Union[str, Path],
    progress: Optional[Callable[[Progress], None]] = None,
) -> None:
    from .io.wav import write_wav_i16

    samples, rate, channels = decode_playlist(paths, progress)
    write_wav_i16(out_path, samples, rate, channels)
    if progress:
        progress(Progress.complete(f"Exported {len(paths)} tracks"))
