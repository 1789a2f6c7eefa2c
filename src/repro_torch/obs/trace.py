"""Low-overhead span/event tracer with Chrome trace-event JSON export.

The serving stack's phase timings (``moe/profile``), migration ticks
(``runtime/migrate``), plan switches, and GPS verdicts today dead-end in
flat metric floats. This tracer turns them into an inspectable timeline:

  * monotonic clock (``time.perf_counter_ns`` — never wall time, so spans
    are immune to NTP steps and match the engines' duration clocks);
  * fixed-capacity ring buffer (old events are overwritten, a ``dropped``
    counter keeps the loss honest — tracing must never grow memory
    unboundedly under a million-user serving loop);
  * nestable spans (per-thread stack, so ``with tracer.span("step")``
    inside ``span("replay")`` renders as a child) and thread safety (one
    lock around the buffer append — the only shared mutation);
  * named *tracks*: virtual threads (e.g. "migration", "gps",
    "dispatch-profile") that render as separate Perfetto rows;
  * a disabled mode whose per-call cost is one attribute check — the
    engines are instrumented unconditionally, so tracer-off overhead on
    the serving step must stay <1% (asserted by the bench gate).

Export follows the Chrome trace-event JSON-object format (the one
Perfetto and chrome://tracing load directly): complete ("X") events with
microsecond ``ts``/``dur``, instant ("i") events, counter ("C") series,
and process/thread-name metadata ("M"). ``validate_chrome_trace`` checks
a document against that schema; CI runs it on the bench trace artifact.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# event tuples: (ph, name, cat, ts_ns, dur_ns, tid, args)
_PH_COMPLETE = "X"
_PH_INSTANT = "i"
_PH_COUNTER = "C"

# Chrome trace-event phases this module emits or the validator accepts.
KNOWN_PHASES = frozenset("XiCMbBEensOtPNDvR(){}S'TFpsfc")


class _NullSpan:
    """Reusable no-op context manager (disabled tracer / dropped spans)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_args(self, **kw):
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """Open span: records a complete ("X") event on exit."""
    __slots__ = ("tracer", "name", "cat", "tid", "args", "t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 tid: int, args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args
        self.t0 = 0

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def set_args(self, **kw):
        """Attach/extend args after entry (e.g. counts known only once
        the work inside the span ran)."""
        self.args = {**(self.args or {}), **kw}

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.tracer._append((_PH_COMPLETE, self.name, self.cat, self.t0,
                             t1 - self.t0, self.tid, self.args))
        return False


class SpanTracer:
    """Ring-buffered span/event recorder exporting Chrome trace JSON."""

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 process_name: str = "repro-serve", pid: int = 1):
        self.enabled = bool(enabled)
        self.capacity = max(int(capacity), 1)
        self.process_name = process_name
        self.pid = int(pid)
        self.dropped = 0
        self._buf: List[Tuple] = []
        self._head = 0                      # next overwrite index when full
        self._lock = threading.Lock()
        self._tracks: Dict[str, int] = {}   # track name -> synthetic tid
        self._next_track_tid = 1 << 20      # keep clear of real thread ids

    # ------------------------------------------------------------- recording
    def now_ns(self) -> int:
        return time.perf_counter_ns()

    def _append(self, ev: Tuple) -> None:
        with self._lock:
            if len(self._buf) < self.capacity:
                self._buf.append(ev)
            else:                           # ring: overwrite the oldest
                self._buf[self._head] = ev
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1

    def _tid(self, track: Optional[str]) -> int:
        if track is None:
            return threading.get_ident() & 0xFFFFF
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                tid = self._tracks.setdefault(track, self._next_track_tid
                                              + len(self._tracks))
        return tid

    def span(self, name: str, cat: str = "serve",
             track: Optional[str] = None, args: Optional[dict] = None):
        """Context manager timing a nested span. Nesting is rendered by
        the viewer from containment (same tid + enclosing [ts, ts+dur))."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, self._tid(track), args)

    def instant(self, name: str, cat: str = "serve",
                track: Optional[str] = None,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._append((_PH_INSTANT, name, cat, time.perf_counter_ns(), 0,
                      self._tid(track), args))

    def counter(self, name: str, value: float, cat: str = "serve",
                track: Optional[str] = None,
                series: str = "value") -> None:
        """One sample of a counter series (rendered as a Perfetto graph)."""
        if not self.enabled:
            return
        self._append((_PH_COUNTER, name, cat, time.perf_counter_ns(), 0,
                      self._tid(track), {series: float(value)}))

    def add_span(self, name: str, dur_s: float, *, ts_ns: Optional[int] = None,
                 cat: str = "serve", track: Optional[str] = None,
                 args: Optional[dict] = None) -> int:
        """Record a RETROSPECTIVE span of known duration (e.g. a phase
        timing measured by ``moe/profile`` outside any live span). Returns
        the span's end timestamp so callers can lay out a sequence.
        """
        if not self.enabled:
            return ts_ns or 0
        t0 = time.perf_counter_ns() if ts_ns is None else int(ts_ns)
        dur = max(int(dur_s * 1e9), 0)
        self._append((_PH_COMPLETE, name, cat, t0, dur, self._tid(track),
                      args))
        return t0 + dur

    # --------------------------------------------------------------- export
    def events(self) -> List[Tuple]:
        """Buffered events in emission order (oldest surviving first)."""
        with self._lock:
            return self._buf[self._head:] + self._buf[:self._head]

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON-object document (Perfetto-loadable)."""
        out = [{"ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
                "args": {"name": self.process_name}}]
        for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            out.append({"ph": "M", "name": "thread_name", "pid": self.pid,
                        "tid": tid, "args": {"name": track}})
        for ph, name, cat, ts_ns, dur_ns, tid, args in self.events():
            ev: Dict[str, Any] = {"ph": ph, "name": name, "cat": cat,
                                  "ts": ts_ns // 1000, "pid": self.pid,
                                  "tid": tid}
            if ph == _PH_COMPLETE:
                ev["dur"] = max(dur_ns // 1000, 1)   # sub-us spans stay visible
            elif ph == _PH_INSTANT:
                ev["s"] = "t"
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "capacity": self.capacity}}

    def export(self, path: str, extra: Optional[Dict[str, Any]] = None) -> dict:
        """Write the Chrome trace JSON to ``path``; ``extra`` is merged
        into ``otherData`` (side-channel payloads like the GPS audit log
        ride along in the same artifact — viewers ignore unknown keys)."""
        doc = self.to_chrome()
        if extra:
            doc["otherData"].update(extra)
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


#: Shared disabled tracer — instrument unconditionally, pay ~nothing.
NULL_TRACER = SpanTracer(capacity=1, enabled=False)


def merge_traces(docs: Sequence[Dict[str, Any]],
                 names: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Merge Chrome trace documents into one, re-keying pids so processes
    stay distinct rows (the bench merges the meshed-subprocess engine's
    trace into the driver's; the fleet merges one doc per model instance).

    Every distinct (input doc, original pid) pair gets a fresh pid, so
    the merge is collision-free for any number of docs including docs
    that already carry several processes. With ``names``, each merged
    process row is tagged with its doc's model/tenant name: a single-pid
    doc's process is renamed to exactly ``names[i]``; a multi-pid doc's
    processes become ``"{names[i]}/{original}"`` so sibling processes
    inside one doc stay distinguishable."""
    merged: Dict[str, Any] = {"traceEvents": [], "displayTimeUnit": "ms",
                              "otherData": {}}
    next_pid = 1
    for i, doc in enumerate(docs):
        events = doc.get("traceEvents", [])
        pid_map: Dict[Any, int] = {}
        for ev in events:
            p = ev.get("pid", 0)
            if p not in pid_map:
                pid_map[p] = next_pid
                next_pid += 1
        name = names[i] if names and i < len(names) else None
        multi = len(pid_map) > 1
        named_pids = set()
        for ev in events:
            ev = dict(ev)
            orig = ev.get("pid", 0)
            ev["pid"] = pid_map[orig]
            if (name is not None and ev.get("ph") == "M"
                    and ev.get("name") == "process_name"):
                old = (ev.get("args") or {}).get("name", orig)
                ev["args"] = {"name": f"{name}/{old}" if multi else name}
                named_pids.add(orig)
            merged["traceEvents"].append(ev)
        if name is not None:
            # docs missing a process_name metadata row still get tagged
            for orig, pid in pid_map.items():
                if orig not in named_pids:
                    merged["traceEvents"].append(
                        {"ph": "M", "name": "process_name", "pid": pid,
                         "tid": 0,
                         "args": {"name": f"{name}/{orig}" if multi
                                  else name}})
        for k, v in doc.get("otherData", {}).items():
            merged["otherData"][f"p{i + 1}_{k}" if k in merged["otherData"]
                                or len(docs) > 1 else k] = v
    return merged


def validate_chrome_trace(doc: Any) -> List[str]:
    """Validate a document against the Chrome trace-event JSON-object
    schema (the subset Perfetto requires to load it). Returns a list of
    human-readable errors — empty means the trace is loadable."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be a JSON object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-list 'traceEvents'"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: event must be an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in KNOWN_PHASES:
            errors.append(f"{where}: bad phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing 'name'")
        if ph == "M":
            continue                      # metadata events carry no ts
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: missing/negative 'ts' ({ts!r})")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: 'X' event needs 'dur' >= 0")
        if "pid" not in ev or "tid" not in ev:
            errors.append(f"{where}: missing pid/tid")
        args = ev.get("args")
        if args is not None and not isinstance(args, dict):
            errors.append(f"{where}: 'args' must be an object")
        if len(errors) >= 50:
            errors.append("... (truncated)")
            break
    return errors


def span_names(doc: Any) -> set:
    """Names of all non-metadata events in a trace document. Tolerates
    malformed documents (returns an empty set) so the validate CLI can
    report schema errors instead of crashing."""
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
    return {ev.get("name") for ev in events
            if isinstance(ev, dict) and ev.get("ph") != "M"}
