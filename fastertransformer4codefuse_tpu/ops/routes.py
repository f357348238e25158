"""Which route each op takes while a program is traced.

A few ops have a second route besides their plain XLA form: prefill
attention through cuDNN (ops/attention.py), decode attention through the
Triton kernel (ops/flash_decode.py), decode-width int8 GEMMs through the
Triton GEMV (ops/int8_gemv.py), and batch-wide int8 x int8 GEMMs
(ops/linear.py, W8A8). The choice is read when JAX traces the op, so it is
made per program: an engine fixes its ``Routes`` when it is built and enters
them only while one of its own programs is traced (``GptNeoXEngine.jit``).
Engines with different weights or meshes in one process therefore never
take each other's routes. Outside any scope every op takes its XLA form.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading


@dataclasses.dataclass(frozen=True)
class Routes:
    flash_prefill: bool = False  # cuDNN fused prefill attention
    flash_decode: bool = False  # Triton decode attention, dense and paged
    int8_gemv: bool = False  # Triton GEMV for stacked int8 weights
    act_int8: bool = False  # int8 x int8 GEMMs at prefill widths (W8A8)
    interpret: bool = False  # Pallas kernels in interpret mode (CPU tests)


_PLAIN = Routes()
_STATE = threading.local()  # tracing happens in the calling thread


def current() -> Routes:
    return getattr(_STATE, "routes", _PLAIN)


@contextlib.contextmanager
def use(routes: Routes):
    """Trace the ops called inside this block with ``routes``."""
    old = current()
    _STATE.routes = routes
    try:
        yield
    finally:
        _STATE.routes = old
