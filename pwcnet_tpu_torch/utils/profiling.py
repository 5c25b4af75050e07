"""The port's tracing: spans at its layer boundaries, the hand kernels'
launch counters and the index tables' counters.

- `span(name, pairs=0)`: a context manager around one phase of the program
  (``serve.load``, ``model.level3``, ``step.backward``, ...). Off, the
  default, it returns one shared no-op object: no clock is read and
  nothing is recorded. On (`enable`), it records per name the count, the
  pairs it was given, the total host seconds and the self seconds (the
  total less the time its child spans cover) and the name of the span it
  was opened in. Inside an active ``torch.profiler`` it also enters
  ``record_function(PREFIX + name)``, so the span sits in the profiler's
  trace on the same clock as the device work it launched.
- `enable(on)`, `snapshot()` (name -> ``{"count", "pairs", "total_s",
  "self_s", "parent"}``) and `reset()`.

The spans live in memory only. Each thread that opens spans keeps its own
stack of open spans; the totals are shared.

The counters, always on (an integer add costs less than the flag test a
span makes):

- ``pwcnet_tpu_torch.ops.cuda.launch_counts()`` and
  ``reset_launch_counts()``: each hand-kernel wrapper counts the calls in
  which it launched its kernel;
- ``pwcnet_tpu_torch.ops.resize.table_counts()`` and
  ``reset_table_counts()``: the lookups of the device-resident index
  tables (the resizes', the sharded loss's rows) and the uploads, the
  lookups that built a table and copied it to its device. After warm-up
  the uploads stay flat; the hit share is ``1 - uploads / lookups``.
"""

from __future__ import annotations

import threading
import time

import torch.autograd.profiler as _autograd_profiler

__all__ = ["PREFIX", "span", "enable", "snapshot", "reset"]

PREFIX = "pwc/"


class _Off:
    """The span of a disabled recorder: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_lock = threading.Lock()
_totals: dict = {}  # name -> [count, pairs, total_ns, self_ns, parent]
_local = threading.local()


class _Span:
    __slots__ = ("name", "pairs", "start", "child_ns", "range")

    def __init__(self, name: str, pairs: int):
        self.name, self.pairs, self.child_ns, self.range = name, pairs, 0, None

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        if _autograd_profiler._is_profiler_enabled:
            self.range = _autograd_profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.start
        stack = _local.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_ns += dur
        if self.range is not None:
            self.range.__exit__(*exc)
        with _lock:
            rec = _totals.get(self.name)
            if rec is None:
                rec = _totals[self.name] = [0, 0, 0, 0, parent.name if parent is not None else None]
            rec[0] += 1
            rec[1] += self.pairs
            rec[2] += dur
            rec[3] += dur - self.child_ns
        return False


def span(name: str, pairs: int = 0):
    """A context manager around one phase named ``name`` that covers
    ``pairs`` rows of work (0 where the phase has no rows of its own)."""
    if not _on:
        return _OFF
    return _Span(name, pairs)


def enable(on: bool) -> None:
    """Turn the spans on or off (off at import)."""
    global _on
    _on = bool(on)


def snapshot() -> dict:
    """What the spans recorded since the last `reset`: name -> ``{"count",
    "pairs", "total_s", "self_s", "parent"}``, ``parent`` the span the
    first of them was opened in (None at the top)."""
    with _lock:
        return {name: {"count": c, "pairs": p, "total_s": t * 1e-9, "self_s": s * 1e-9, "parent": parent}
                for name, (c, p, t, s, parent) in _totals.items()}


def reset() -> None:
    """Forget what the spans recorded (spans open now still record)."""
    with _lock:
        _totals.clear()
