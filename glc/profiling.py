"""Profiling hooks (the rebuild's answer to SURVEY.md §5 "tracing").

The reference has only ad-hoc Instant timing (codec.rs:605, ui.rs:98) and
admits its stages can't be profiled without source changes
(test_performance.rs:159-188).  Here every device stage is a separately
jitted public function, and the host pipelines annotate their phases so a
`jax.profiler` trace attributes time to codec stages:

    with glc.profiling.trace("/tmp/glc-trace"):
        encoder.encode(samples, 2)

or set GLC_PROFILE=/tmp/glc-trace to trace every encode/decode call.
View with TensorBoard's profile plugin or Perfetto.
"""

from __future__ import annotations

import contextlib
import os


def annotate(name: str):
    """Label a host-side phase in the profiler timeline (no-op overhead when
    no trace is active)."""
    import jax

    return jax.profiler.StepTraceAnnotation(name)


def trace(log_dir: str):
    """Context manager capturing a jax.profiler trace of the enclosed calls."""
    import jax

    return jax.profiler.trace(log_dir)


def maybe_trace(name: str):
    """Trace into $GLC_PROFILE/<name> if the env var is set, else no-op."""
    d = os.environ.get("GLC_PROFILE")
    if not d:
        return contextlib.nullcontext()
    return trace(os.path.join(d, name))
