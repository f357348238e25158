"""Profiling annotations and trace capture.

≙ the reference's NVTX ranges (PUSH_RANGE/POP_RANGE around every GEMM and
attention call, /root/reference/src/fastertransformer/utils/nvtx_utils.h:37)
viewed in nsys. Here the equivalents are jax.profiler named traces, viewed in
xprof/tensorboard or reduced to a flat per-op summary of the GPU's device
timelines for headless analysis.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import os
from typing import Dict, List, Tuple

import jax


def annotate(name: str):
    """Named range visible in device traces: ``with annotate("attention"): ...``"""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an xprof trace around a block."""
    with jax.profiler.trace(log_dir):
        yield


def summarize_trace(
    log_dir: str, top: int = 20, line: str = "XLA Ops"
) -> List[Tuple[str, float, int, str]]:
    """Flat per-op device-time summary from the newest trace in ``log_dir``.

    Reads the ``.xplane.pb`` the profiler writes and sums event durations on
    the device planes (``/device:GPU:N``). ``line`` picks which timeline of
    a device plane to read: "XLA Ops" (one event per HLO op) by default; the
    per-stream kernel lines ("Stream #...") when the plane has no such line.
    Returns [(name, total_ms, count, line_name)] sorted by total time.
    """
    from jax.profiler import ProfileData

    paths = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)
    )
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    data = ProfileData.from_file(paths[-1])
    planes = [p for p in data.planes if p.name.startswith("/device:")]
    if not planes:
        raise ValueError(f"no device plane in {paths[-1]}")
    durs = collections.Counter()
    cnt = collections.Counter()
    where: Dict[str, str] = {}
    for plane in planes:
        lines = list(plane.lines)
        picked = [ln for ln in lines if ln.name.startswith(line)] or [
            ln for ln in lines if ln.name.startswith("Stream")
        ]
        for ln in picked:
            for ev in ln.events:
                durs[ev.name] += ev.duration_ns
                cnt[ev.name] += 1
                where.setdefault(ev.name, ln.name)
    return [
        (name, d / 1e6, cnt[name], where[name])
        for name, d in durs.most_common(top)
    ]
