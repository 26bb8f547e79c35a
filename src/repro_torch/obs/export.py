"""The unified Perfetto / Chrome-trace exporter — one serialization of
the canonical event schema, replacing the two ad-hoc emitters that used
to live in ``pipeline.executor`` (TraceEvent capture) and
``planner.calibrate`` (``chrome_trace``).

Layout (open in https://ui.perfetto.dev or chrome://tracing):

  * pid 0 "stages"   — one thread row per pipeline stage; every
    compute-track span is a complete ("X") event named by its
    presentation label (``EVICT3.c1.s2+w``).
  * pid 1 "channels" — one thread row per transfer channel (pair links,
    D2H/H2D host links); channel-occupancy spans land here.
  * pid 0 counters   — ``hbm@<stage>`` counter ("C") tracks: the
    stepwise resident-byte series from ``obs.metrics.hbm_timeline``
    (or the executor's measured store samples riding on the spans).

The round trip is lossless: every span's structured identity
(op/stage/mb/chunk/sl/phase/track/channel/hbm) is written into the
event's ``args`` and ``load_trace`` rebuilds the exact ``Span`` — no
more re-parsing (and dropping) ``.sN``/``+w`` suffixes from name
strings. Legacy traces saved by the old ``calibrate.chrome_trace``
(no structured args) still load: the op string is split back into
(op, sl, phase) by suffix.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from repro_torch.obs import events as E

#: Synthetic process ids grouping the track rows.
PID_STAGES, PID_CHANNELS = 0, 1

_LEGACY_WAIT = re.compile(r"\+w$")
_LEGACY_SLICE = re.compile(r"\.s(\d+)")


def _channel_tid(key: Tuple, index: Dict[Tuple, int]) -> int:
    if key not in index:
        index[key] = len(index)
    return index[key]


def to_chrome(spans: Iterable[E.Span],
              counters: Optional[Mapping[int, List[Tuple[float, float]]]]
              = None,
              time_scale: float = 1e6) -> dict:
    """Serialize spans (+ optional per-stage byte counters) to the
    Chrome trace-event format Perfetto reads. ``time_scale`` converts
    span times to microseconds (1e6 for wall-clock seconds; simulated
    unit-time traces view fine at the same scale)."""
    out: List[dict] = []
    chans: Dict[Tuple, int] = {}
    meta = [
        {"name": "process_name", "ph": "M", "pid": PID_STAGES,
         "args": {"name": "stages"}},
        {"name": "process_name", "ph": "M", "pid": PID_CHANNELS,
         "args": {"name": "channels"}},
    ]
    for s in spans:
        if s.track == E.CHANNEL:
            pid, tid = PID_CHANNELS, _channel_tid(s.channel, chans)
        else:
            pid, tid = PID_STAGES, s.stage
        out.append({
            "name": s.label, "cat": s.op, "ph": "X",
            "ts": s.start * time_scale,
            "dur": s.duration * time_scale,
            "pid": pid, "tid": tid,
            "args": s.to_args(),
        })
    for key, tid in chans.items():
        meta.append({"name": "thread_name", "ph": "M",
                     "pid": PID_CHANNELS, "tid": tid,
                     "args": {"name": ":".join(map(str, key))}})
    if counters:
        for stage in sorted(counters):
            for t, v in counters[stage]:
                out.append({
                    "name": f"hbm@{stage}", "ph": "C",
                    "ts": t * time_scale, "pid": PID_STAGES,
                    "tid": stage, "args": {"bytes": v},
                })
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def save_trace(spans: Iterable[E.Span], path: str,
               counters: Optional[Mapping[int, List[Tuple[float, float]]]]
               = None) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome(spans, counters), f)


def _legacy_span(rec: dict, start: float, end: float) -> E.Span:
    """Rebuild a span from a pre-obs trace record (the old
    ``calibrate.chrome_trace`` format): structured fields live only in
    the op string, so split the ``.sN`` / ``+w`` suffixes back out —
    exactly the distinctions the old loader dropped."""
    op = rec.get("cat") or rec.get("name", "")
    phase = ""
    if _LEGACY_WAIT.search(op):
        op = _LEGACY_WAIT.sub("", op)
        phase = E.WAIT
    sl = 0
    m = _LEGACY_SLICE.search(op)
    if m:
        sl = int(m.group(1))
        op = _LEGACY_SLICE.sub("", op)
    args = rec.get("args", {})
    return E.make(op, rec.get("tid", 0), args.get("mb", 0),
                  args.get("chunk", 0), sl, phase, start, end)


def load_trace(path: str) -> List[E.Span]:
    """Parse a saved trace back into ``Span``s — bit-exact for traces
    this exporter wrote (structured args), best-effort suffix parsing
    for legacy ``chrome_trace`` files."""
    with open(path) as f:
        doc = json.load(f)
    spans: List[E.Span] = []
    for rec in doc.get("traceEvents", []):
        if rec.get("ph") != "X":
            continue
        start = rec["ts"] / 1e6
        end = start + rec.get("dur", 0.0) / 1e6
        args = rec.get("args", {})
        if "op" in args:
            spans.append(E.from_args(args, start, end))
        else:
            spans.append(_legacy_span(rec, start, end))
    return spans
