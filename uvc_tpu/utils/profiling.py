"""Profiling hooks (SURVEY.md §5: the reference prints wall/CPU time at
exit, main.cpp:1221-1222,1593-1600; this build additionally exposes
JAX profiler traces for the device stages).

Set UVC_TPU_JAX_TRACE_DIR=/some/dir to capture a JAX profiler trace
(viewable in TensorBoard / Perfetto) around any code wrapped in
``maybe_trace``; without the env var the context manager is a no-op so
the hot path pays nothing.
"""

import contextlib
import os

ENV_VAR = "UVC_TPU_JAX_TRACE_DIR"


@contextlib.contextmanager
def maybe_trace(label: str):
    """Wrap a device-work section in a jax.profiler trace when
    UVC_TPU_JAX_TRACE_DIR is set; otherwise a zero-cost no-op."""
    trace_dir = os.environ.get(ENV_VAR)
    if not trace_dir:
        yield
        return
    import jax

    os.makedirs(trace_dir, exist_ok=True)
    with jax.profiler.trace(trace_dir):
        with jax.profiler.TraceAnnotation(label):
            yield
