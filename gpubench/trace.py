"""From a ``torch.profiler`` Chrome trace of the window to what the
per-layer readers and the ``breakdown`` take: device time per kernel
group inside the denoise steps, the busy share of the window, the device
operations that took most time and the longest idle gaps, each named by
the host operation that was open across it.

Kernel groups follow the port's smoke script (``phase_profile``): the
fused attention's one-pass and multi-pass instances and their prep, the
int8 kernels, library GEMMs, and the rest (elementwise work).
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160         # a kernel's name as the breakdown keeps it


def kernel_group(name: str) -> str:
    if re.search(r"w8a8_(wgmma|gemv|mma)_kernel", name):
        return "b4"
    if re.search(r"(attn|stats|quant)_kernel<", name):
        return "b7"
    if "fwd_kernel" in name and "Fused<true" in name:
        return "b3"
    if ("fwd_kernel" in name and "Fused<" in name) \
            or "norm_rope_kernel" in name:
        return "b12"
    if re.search(r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitk", name, re.I):
        return "gemm"
    return "other"


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def reduce_trace(path: str, window_s: float) -> Dict:
    """Read the Chrome trace at ``path`` (times in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, steps = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e["name"]))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "cuda_driver", "python_function"):
            host.append((ts, ts + dur, e["name"]))
            if cat == "user_annotation" and e["name"] == "step":
                steps.append((ts, ts + dur))
    device.sort()
    busy_us = _union([(a, b) for a, b, _ in device])

    # device time by group inside the step spans (each ends synchronised,
    # so a step's kernels lie inside its host interval)
    steps.sort()
    starts = [a for a, _ in steps]
    groups: Dict[str, float] = {}
    for a, b, name in device:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and b <= steps[i][1]:
            g = kernel_group(name)
            groups[g] = groups.get(g, 0.0) + (b - a) * 1e-6

    per_op: Dict[str, float] = {}
    for a, b, name in device:
        per_op[name] = per_op.get(name, 0.0) + (b - a) * 1e-6
    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    top_ops = [(name[:NAME_CHARS], sec) for name, sec in top_ops]

    gaps = []
    end = device[0][1] if device else 0.0
    for a, b, _ in device[1:]:
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:10]:
        mid = (a + b) / 2
        open_ops = [(ha, hb, n) for ha, hb, n in host if ha <= mid <= hb]
        # the innermost host operation open across the gap
        label = min(open_ops, key=lambda o: o[1] - o[0])[2] if open_ops \
            else "host: no traced operation"
        named.append([label[:NAME_CHARS], length * 1e-6])
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "groups": groups, "steps_traced": len(steps),
            "device_ops": [[n, s] for n, s in top_ops],
            "idle_gaps": named}
