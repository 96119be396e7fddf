"""Structured logging + progress reporting (SPLOG / progress_handler analog).

The reference logs through SPLOG to a forked logger process appending
qc/create_log.txt (modules/io/log.h:13-24, main/main.cpp:63-95) and threads
`progress_handler_t` closures through every long operation with subprogress
splitting (modules/io/progress.h).  This build keeps one process: a
module-level structured logger (timestamped, level-tagged, optionally teed
to a file) and a Progress tree whose stages report fraction + wall time.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import IO, List, Optional

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARN": 30, "ERROR": 40}


class Logger:
    """Timestamped line logger, tee-able to a file (create_log.txt analog)."""

    def __init__(self, name: str = "bgt"):
        self.name = name
        self.level = _LEVELS.get(os.environ.get("BGT_LOG_LEVEL", "INFO"), 20)
        self._file: Optional[IO] = None

    def tee_to(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._file = open(path, "a")
        return self

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def _emit(self, level: str, msg: str, **fields):
        if _LEVELS[level] < self.level:
            return
        t = time.strftime("%Y-%m-%d %H:%M:%S")
        extra = (
            " " + " ".join(f"{k}={v}" for k, v in fields.items())
            if fields
            else ""
        )
        line = f"{t} [{level}] {self.name}: {msg}{extra}"
        print(line, file=sys.stderr if level in ("WARN", "ERROR") else sys.stdout)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()

    def debug(self, msg, **f):
        self._emit("DEBUG", msg, **f)

    def info(self, msg, **f):
        self._emit("INFO", msg, **f)

    def warn(self, msg, **f):
        self._emit("WARN", msg, **f)

    def error(self, msg, **f):
        self._emit("ERROR", msg, **f)


LOG = Logger()


@contextmanager
def maybe_profile(tag: str):
    """Per-kernel device profiling (gperftools --cpuprofile-dir analog,
    modules/main/main.h:57): when BGT_PROFILE_DIR is set, wrap the block in
    a jax.profiler trace — per-XLA-op timings land in
    $BGT_PROFILE_DIR/<tag>/ and open in TensorBoard/xprof/Perfetto."""
    base = os.environ.get("BGT_PROFILE_DIR")
    if not base:
        yield
        return
    import jax

    out = os.path.join(base, tag)
    os.makedirs(out, exist_ok=True)
    LOG.info(f"profiling {tag} -> {out}")
    with jax.profiler.trace(out):
        yield


@dataclass
class Progress:
    """A stage-progress tree (progress_handler_t + subprogress analog).

    Stages report set(fraction); timings collect into a dict suitable for
    qc/timings.json.  Rendering is rate-limited to avoid log spam."""

    label: str = "run"
    logger: Logger = field(default_factory=lambda: LOG)
    min_interval_s: float = 2.0
    _t0: float = field(default_factory=time.time)
    _last_print: float = 0.0
    timings: dict = field(default_factory=dict)
    # runtime_stats analog (modules/io/runtime_stats.h:14-50): per-stage
    # wall + cpu_user + cpu_sys + end_time, plus free-form counters
    # (autostats analog, modules/io/autostats.h:25)
    stages: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str, weight: float = 1.0):
        sub = _Stage(self, name)
        t0 = time.time()
        c0 = os.times()
        self.logger.info(f"{self.label}/{name}: start")
        try:
            yield sub
        finally:
            dt = time.time() - t0
            c1 = os.times()
            self.timings[name] = round(dt, 3)
            self.stages.append(
                {
                    "name": name,
                    "end_time": int(time.time()),
                    "wall_seconds": round(dt, 3),
                    "cpu_user_seconds": round(c1.user - c0.user, 3),
                    "cpu_sys_seconds": round(c1.system - c0.system, 3),
                }
            )
            self.logger.info(f"{self.label}/{name}: done", seconds=round(dt, 2))

    def add(self, name: str, value):
        """Record a named stat (runtime_stats::add analog)."""
        self.counters[name] = value

    def count(self, name: str, delta: int = 1):
        """Bump a counter (autostats counter analog)."""
        self.counters[name] = self.counters.get(name, 0) + delta

    def save_timings(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.timings, f, indent=1)

    def stats_dict(self) -> dict:
        """The qc/create_stats.json payload (runtime_stats::save analog)."""
        return {"stages": self.stages, **({"counters": self.counters} if self.counters else {})}


class _Stage:
    def __init__(self, parent: Progress, name: str):
        self.parent = parent
        self.name = name

    def set(self, fraction: float, detail: str = ""):
        now = time.time()
        if now - self.parent._last_print < self.parent.min_interval_s:
            return
        self.parent._last_print = now
        pct = min(max(fraction, 0.0), 1.0) * 100
        msg = f"{self.parent.label}/{self.name}: {pct:.0f}%"
        if detail:
            msg += f" ({detail})"
        self.parent.logger.info(msg)
