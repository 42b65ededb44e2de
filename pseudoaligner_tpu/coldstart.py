"""Cold-start attribution: capture jax compile/cache events.

The monitor captures jax's internal log events (persistent-cache hit or
miss per executable, tracing / lowering / XLA compile durations), so
set-up time can be split into the program's own compile work and the
rest.  bench.py and chip_smoke.py report its summary.
"""

from __future__ import annotations

import logging
import re
import time

_WATCHED = (
    "jax._src.compiler",
    "jax._src.interpreters.pxla",
    "jax._src.dispatch",
)

_PATTERNS = (
    ("cache_hit", re.compile(r"Persistent compilation cache hit for '([^']+)'")),
    ("cache_miss", re.compile(r"PERSISTENT COMPILATION CACHE MISS for '([^']+)'")),
    ("trace", re.compile(r"Finished tracing \+ transforming (\S+).* in ([0-9.e+-]+) sec")),
    ("lower", re.compile(r"Finished jaxpr to MLIR module conversion (\S+) in ([0-9.e+-]+) sec")),
    ("compile", re.compile(r"Finished XLA compilation of (\S+) in ([0-9.e+-]+) sec")),
)


class JitEventMonitor:
    """Attach to jax's compiler/dispatch loggers and collect cache and
    phase events.  start()/stop() save and restore logger state;
    propagation is muted while active so DEBUG records don't flood the
    process's stderr handlers."""

    def __init__(self):
        self.events: list[tuple[float, str, str, float | None]] = []
        self._saved: list[tuple[logging.Logger, int, bool]] = []
        self._handler: logging.Handler | None = None

    def start(self) -> "JitEventMonitor":
        mon = self

        class _H(logging.Handler):
            def emit(self, rec):
                msg = rec.getMessage()
                for kind, pat in _PATTERNS:
                    m = pat.search(msg)
                    if m:
                        dur = (float(m.group(2))
                               if m.lastindex and m.lastindex >= 2 else None)
                        mon.events.append(
                            (time.time(), kind, m.group(1), dur)
                        )
                        return
                # propagation is muted while active (so DEBUG records
                # don't flood stderr) — hand real diagnostics through to
                # the root handlers ourselves
                if rec.levelno >= logging.WARNING:
                    logging.getLogger().handle(rec)

        self._handler = _H(level=logging.DEBUG)
        for name in _WATCHED:
            lg = logging.getLogger(name)
            self._saved.append((lg, lg.level, lg.propagate))
            lg.addHandler(self._handler)
            lg.setLevel(logging.DEBUG)
            lg.propagate = False
        return self

    def stop(self) -> None:
        for lg, level, prop in self._saved:
            if self._handler is not None:
                lg.removeHandler(self._handler)
            lg.setLevel(level)
            lg.propagate = prop
        self._saved = []

    def summary(self) -> dict:
        out = {
            "cache_hits": 0,
            "cache_misses": 0,
            "trace_s": 0.0,
            "lower_s": 0.0,
            "xla_compile_s": 0.0,
            "modules": [],
        }
        for _ts, kind, name, dur in self.events:
            if kind == "cache_hit":
                out["cache_hits"] += 1
            elif kind == "cache_miss":
                out["cache_misses"] += 1
                out["modules"].append(name)
            elif kind == "trace":
                out["trace_s"] += dur or 0.0
            elif kind == "lower":
                out["lower_s"] += dur or 0.0
            elif kind == "compile":
                out["xla_compile_s"] += dur or 0.0
        out["trace_s"] = round(out["trace_s"], 3)
        out["lower_s"] = round(out["lower_s"], 3)
        out["xla_compile_s"] = round(out["xla_compile_s"], 3)
        out["modules"] = out["modules"][:8]  # bound the artifact size
        return out
