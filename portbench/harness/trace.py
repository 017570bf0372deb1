"""The traced window: ``torch.profiler`` over the whole window, device
activity only (recording every host op would double a host-bound step),
reduced in memory to what the per-layer readers take. Nothing of the trace
is written to disk.

- Device busy time is the union of the intervals of every device
  operation (kernels, copies, fills), so operations that overlap count
  once; the window's length is the host clock's.
- Kernel time by class sums each kernel's duration under
  :func:`kernel_class`, a frozen copy of ``chip_smoke.py``'s, so that a
  later PR cannot move the yardstick by renaming.
- The benchmark's own host spans (:class:`Spans`: the request, its
  dispatch, its sync) are kept on the wall clock, in the profiler's time
  base, and label each idle gap of the device by the span that the host
  was inside when it began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple


def kernel_class(name: str) -> str:
    """A coarse class of a CUDA kernel, by its name."""
    if any(t in name for t in ("decode_partial", "decode_combine", "decode_ring")):
        return "decode attention K7"
    if any(t in name for t in ("ssd_bwd", "ssd_grad")):
        return "SSD backward K8b"
    if any(t in name for t in ("wkv_bwd", "wkv_grad")):
        return "WKV backward K12b"
    if any(t in name for t in ("ssd_kernel", "ssd_states", "ssd_out")):
        return "SSD scan K8"
    if "state_pass" in name:
        return "state passes of K8, K12, K8b and K12b"
    if "flash_" in name:
        return "attention K4-K6"
    if "gmm_bwd" in name:
        return "expert backward K9b"
    if "gmm_" in name:
        return "expert products K9"
    if "rmsnorm_" in name:
        return "RMSNorm K10/K11"
    if any(t in name for t in ("wkv_kernel", "wkv_states", "wkv_out")):
        return "WKV scan K12"
    if "f32f32" in name or "sgemm" in name:
        return "float32 GEMM"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "bf16 GEMM"
    if any(t in name for t in ("elementwise", "reduce", "Reduce", "index", "gather", "scatter",
                               "cat", "copy", "fill", "softmax", "norm")):
        return "elementwise, copies and reductions"
    return "other"


class Spans:
    """The benchmark's host spans of a traced window: (start ns, end ns,
    name) on the wall clock; nothing recorded when ``on`` is false."""

    _OFF = contextlib.nullcontext()

    def __init__(self, on: bool):
        self.on = on
        self.items: List[Tuple[int, int, str]] = []

    def __call__(self, name: str):
        return self._span(name) if self.on else self._OFF

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((t0, time.time_ns(), name))


def profiler():
    """The profiler of a traced window: device activity."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA], record_shapes=False, with_stack=False,
                   profile_memory=False)


def union_s(intervals: List[Tuple[int, int]]) -> float:
    """Seconds covered by the union of [start, end) intervals in ns."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    out = []
    cur = lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [g for g in out if g[1] > g[0]]


class Reduced:
    """What the readers take from a traced window."""

    def __init__(self, window_s: float, busy_s: float, class_s: Dict[str, float],
                 by_kernel: Counter, idle_gaps: List[Tuple[str, float]]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.class_s = class_s
        self.by_kernel = by_kernel
        self.idle_gaps = idle_gaps

    def breakdown(self) -> dict:
        ops = [[f"{kernel_class(n)}: {n[:96]}", s] for n, s in self.by_kernel.most_common(10)]
        return {"device_ops": ops, "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def _events(prof):
    try:
        return prof.profiler.kineto_results.events()
    except AttributeError:
        return None


def reduce(prof, spans: "Spans", window_s: float) -> Optional[Reduced]:
    """The window's device busy time, kernel time by class and by name and
    its longest idle gaps; None where the trace holds no device operation.
    ``window_s``: the window's length on the host clock."""
    import torch

    evs = _events(prof)
    if evs is None:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[int, int]] = []
    by_kernel: Counter = Counter()
    for e in evs:
        if e.device_type() != cuda or getattr(e, "is_user_annotation", lambda: False)():
            continue
        s = e.start_ns()
        d = e.duration_ns()
        dev.append((s, s + d))
        by_kernel[e.name()] += d / 1e9
    if not dev:
        return None
    busy = union_s(dev)
    class_s: Dict[str, float] = Counter()
    for n, sec in by_kernel.items():
        class_s[kernel_class(n)] += sec
    labelled: List[Tuple[str, float]] = []
    items = sorted(spans.items)
    if items:
        lo, hi = items[0][0], max(e for _, e, _ in items)
        # the host's last span ends when the device's last work has come
        # back: a shift of the device's clock onto the host's, where the two
        # differ by more than a millisecond
        shift = hi - max(e for _, e in dev)
        shift = shift if abs(shift) > 1_000_000 else 0
        starts = [s for s, _, _ in items]
        for g0, g1 in gaps([(s + shift, e + shift) for s, e in dev], lo, hi):
            i = bisect.bisect_right(starts, g0) - 1
            label = "outside any span"
            # the span that holds the gap's start: the latest started (spans
            # follow one another; one may sit inside the one before)
            for j in (i, i - 1):
                if j >= 0 and items[j][1] > g0:
                    label = items[j][2]
                    break
            labelled.append((label, (g1 - g0) / 1e9))
        labelled.sort(key=lambda x: -x[1])
    return Reduced(window_s, busy, dict(class_s), by_kernel, labelled)
