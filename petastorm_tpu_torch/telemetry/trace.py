"""Span tracing with thread/worker attribution; Chrome trace_event export.

Spans are complete events ("ph": "X" in the Chrome trace format): one append
per finished span carrying (name, category, thread, start, duration, args).
The buffer is bounded - a run that records more spans than ``max_events``
drops the excess and counts them, so an unbounded soak cannot grow host
memory without bound.

``chrome_trace()`` renders the JSON object format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
loadable directly in Perfetto / chrome://tracing: every event has ``ph``,
``ts``/``dur`` (microseconds), ``pid``/``tid``, ``name``, ``cat``, ``args``,
plus ``thread_name`` metadata events so worker threads show up by name.

Cross-process spans: ``add(..., pid=..., proc=...)`` attributes a span to a
*synthetic* process row (e.g. the dispatcher or a remote worker whose hop
stamps were returned over the wire).  ``chrome_trace()`` emits a
``process_name`` metadata event per synthetic pid, so a merged trace of one
item's life across client -> dispatcher -> worker -> client renders as
separate named process tracks in a single Perfetto file.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class TraceBuffer:
    """Bounded in-memory span store (one tuple per finished span)."""

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        #: (name, cat, tid, start_ns, dur_ns, args-or-None, pid-or-None)
        self._events: List[tuple] = []
        self._max_events = max_events
        self._dropped = 0
        self._thread_names: Dict[int, str] = {}
        #: synthetic pid -> process name for cross-process spans
        self._proc_names: Dict[int, str] = {}
        #: perf_counter_ns at buffer creation - trace timestamps are relative
        #: to this origin so they stay small and runs align at ts=0
        self._origin_ns = time.perf_counter_ns()

    def add(self, name: str, cat: str, start_ns: int, dur_ns: int,
            args: Optional[Dict] = None, pid: Optional[int] = None,
            proc: Optional[str] = None, tid: Optional[int] = None) -> None:
        """Append one finished span (attributed to the CALLING thread, so
        call from the thread that did the work).  ``pid``/``proc`` attribute
        the span to a synthetic remote process instead (the merged-trace
        path); ``start_ns`` must then already be mapped into this buffer's
        clock domain by the caller."""
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            if pid is None and tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            if pid is not None and proc and pid not in self._proc_names:
                self._proc_names[pid] = proc
            self._events.append((name, cat, tid, start_ns, dur_ns, args, pid))

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Spans discarded because the buffer hit ``max_events``."""
        return self._dropped

    def tail(self, n: int = 200) -> List[Dict]:
        """The last ``n`` finished spans as plain dicts, oldest first:
        ``{name, cat, thread, ts_ms, dur_ms[, args]}`` (milliseconds relative
        to the buffer origin, same clock as ``chrome_trace`` timestamps) -
        the flight recorder's trace payload."""
        if n <= 0:
            return []
        with self._lock:
            events = self._events[-n:]
            names = dict(self._thread_names)
            procs = dict(self._proc_names)
        origin = self._origin_ns
        out = []
        for name, cat, tid, start_ns, dur_ns, args, pid in events:
            ev = {"name": name, "cat": cat,
                  "thread": names.get(tid, str(tid)),
                  "ts_ms": (start_ns - origin) / 1e6,
                  "dur_ms": dur_ns / 1e6}
            if pid is not None:
                ev["proc"] = procs.get(pid, str(pid))
            if args:
                ev["args"] = args
            out.append(ev)
        return out

    def chrome_trace(self) -> Dict:
        """The buffered spans as a Chrome ``trace_event`` JSON object."""
        pid = os.getpid()
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
            procs = dict(self._proc_names)
        origin = self._origin_ns
        out = [{"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                "args": {"name": tname}} for tid, tname in names.items()]
        out.append({"ph": "M", "pid": pid, "name": "process_name",
                    "args": {"name": "petastorm-tpu"}})
        for spid, pname in procs.items():
            out.append({"ph": "M", "pid": spid, "name": "process_name",
                        "args": {"name": pname}})
        for name, cat, tid, start_ns, dur_ns, args, epid in events:
            ev = {"ph": "X", "pid": pid if epid is None else epid, "tid": tid,
                  "name": name, "cat": cat,
                  "ts": (start_ns - origin) / 1e3,   # microseconds
                  "dur": dur_ns / 1e3}
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        """Write ``chrome_trace()`` JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path
