"""Reading the train CLI's ``--profile_dir`` trace: ``<dir>/trace.json``, the
chrome trace of ``torch.profiler`` with one ``train_step_<n>`` span per
traced step (steps 3-5).

``split_trace`` splits each traced step's wall time (its span on the host,
which ends with the step's ``torch.cuda.synchronize``) into

- ``field_ms``: the card busy in the field's kernels (names holding
  ``resnetfc_``),
- ``other_ms``: the card busy in anything else (the encoder's convolutions,
  elementwise kernels, copies),
- ``idle_ms``: the card idle,

and each of those again over the step's phases on the host: ``forward``
(from the step's start to its first backward node), ``backward`` (the
autograd engine's nodes, ``autograd::engine::evaluate_function``),
``optimizer`` (``Optimizer.step``) and ``rest`` (the loss and gradient norm
between them, the closing synchronize).  It also lists the device ops that
took the most time and the longest idle gaps, each with the innermost host
span that covers most of it (what the host was doing while the card
waited)."""

from __future__ import annotations

import json
import re
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
STEP_SPAN = re.compile(r"^train_step_(\d+)$")
BACKWARD_NODE = "autograd::engine::evaluate_function"
OPTIMIZER_STEP = "Optimizer.step"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _within(intervals, a: float, b: float) -> float:
    """Length of a sorted, disjoint interval list inside [a, b]."""
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in intervals)


def _span(e) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def _phases(host: List[dict], t0: float, t1: float) -> Dict[str, Tuple[float, float]]:
    """The step's host phases as time ranges: forward, backward, optimizer;
    ``rest`` is what they leave of [t0, t1]."""
    inside = [e for e in host if t0 <= float(e["ts"]) < t1]
    bw = [_span(e) for e in inside if e["name"].startswith(BACKWARD_NODE)]
    opt = [_span(e) for e in inside if e["name"].startswith(OPTIMIZER_STEP)]
    if not bw:
        return {}
    b0, b1 = min(a for a, _ in bw), max(b for _, b in bw)
    phases = {"forward": (t0, b0), "backward": (b0, b1)}
    if opt:
        phases["optimizer"] = (max(b1, min(a for a, _ in opt)), min(t1, max(b for _, b in opt)))
    return phases


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def step_spans(events: List[dict]) -> Dict[int, Tuple[float, float]]:
    """{step: (start us, end us)} of the host's ``train_step_<n>`` spans."""
    spans = {}
    for e in events:
        m = STEP_SPAN.match(e.get("name", ""))
        if m and e.get("cat") == "user_annotation":
            spans[int(m.group(1))] = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    return spans


def split_trace(path: str, field_marker: str = "resnetfc_", top: int = 8) -> dict:
    """``{"steps": {n: {"wall_ms", "field_ms", "other_ms", "idle_ms",
    "field_launches": {kernel: count}, "phases": {phase: {"wall_ms",
    "busy_ms", "idle_ms"}}}}, "top_ops": [(name, ms, count)], "gaps": [(ms,
    step, host span name)]}`` over the traced steps."""
    events = load_events(path)
    spans = step_spans(events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS and not STEP_SPAN.match(e["name"])]
    steps, ops, gaps = {}, {}, []
    for n, (t0, t1) in sorted(spans.items()):
        busy, field, launches = [], [], {}
        for e in device:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if b <= t0 or a >= t1:
                continue
            a, b = max(a, t0), min(b, t1)
            busy.append((a, b))
            name = e["name"]
            tot, cnt = ops.get(name, (0.0, 0))
            ops[name] = (tot + (b - a), cnt + 1)
            if field_marker in name:
                field.append((a, b))
                short = re.search(r"(resnetfc_\w+?)(_kernel|\b|<)", name)
                key = short.group(1) if short else name
                launches[key] = launches.get(key, 0) + 1
        busy, field = _union(busy), _union(field)
        steps[n] = {"wall_ms": (t1 - t0) / 1e3, "field_ms": _length(field) / 1e3,
                    "other_ms": (_length(busy) - _length(field)) / 1e3,
                    "idle_ms": (t1 - t0 - _length(busy)) / 1e3, "field_launches": launches}
        phases = _phases(host, t0, t1)
        if phases:
            split = {}
            for name, (a, b) in phases.items():
                on = _within(busy, a, b)
                split[name] = {"wall_ms": (b - a) / 1e3, "busy_ms": on / 1e3,
                               "idle_ms": (b - a - on) / 1e3}
            rest = {k: steps[n][k] - sum(v[k] for v in split.values())
                    for k in ("wall_ms", "idle_ms")}
            split["rest"] = {"wall_ms": rest["wall_ms"], "busy_ms": rest["wall_ms"] - rest["idle_ms"],
                             "idle_ms": rest["idle_ms"]}
            steps[n]["phases"] = split
        edges = [t0] + [x for iv in busy for x in iv] + [t1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, n, a, b))
    gaps.sort(reverse=True)
    out_gaps = []
    for dur, n, a, b in gaps[:top]:
        # the innermost host span covering at least half of the gap
        cover = [(float(e["dur"]), e["name"]) for e in host
                 if min(b, float(e["ts"]) + float(e["dur"])) - max(a, float(e["ts"]))
                 >= 0.5 * (b - a)]
        out_gaps.append((dur / 1e3, n, min(cover)[1] if cover else None))
    top_ops = sorted(((k, v[0] / 1e3, v[1]) for k, v in ops.items()), key=lambda x: -x[1])
    return {"steps": steps, "top_ops": top_ops[:top], "gaps": out_gaps}
