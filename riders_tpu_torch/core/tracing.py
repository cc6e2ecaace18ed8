"""Spans of the port's served path: one in-memory recorder.

`span(name)` times a block of host work.  It is live while the recorder
is enabled (`enable()` / `disable()`) or while a torch profiler runs
anywhere in the process; otherwise it returns one shared no-op object
after a single flag check.  A live span appends a `Span` (name,
request, parent, thread, start_ns, end_ns on `time.perf_counter_ns`) to
a bounded ring that keeps the newest records, and while a profiler runs
it also opens a range of its name: on the thread that started the
profiler that is a host range on the profiler's clock.  Ranges opened
on other threads do not reach the profiler's trace; their spans are in
the ring.

`span(name, mirror=True)` opens a user range
(`torch.profiler.record_function`), which the profiler also mirrors onto
the device's timeline, over the kernels launched inside it.  The
profiler gives each kernel to the innermost user range open at its
launch, so a mirrored span takes its kernels out of the mirror of any
user range around it; a plain span's range claims none.

`request(seq)` names the batch the calling thread works on; the spans it
opens after that carry `seq` until the next call.  `offset_ns()` is the
profiler's clock (Unix-epoch ns on Linux) less `perf_counter_ns`, so
that spans of any thread can be put on the device trace's clock.

Span names on the served path (`pipelines/serving.py`,
`pipelines/fused.py`): `server.upload` (uploader thread),
`server.wait_upload`, `fused.call` and its stages `fused.inputs`,
`fused.rcnet`, `fused.compose`, `fused.stage1`, `fused.sml`,
`fused.upsample`, then `server.download` and `server.wait_result`.
Inside the SML: `dpt.attn`, mirrored, once per BEiT block
(`models/dpt.py`) and once per Swin V2 block (`models/swin2.py`), from
after the qkv projection up to the output projection.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _HostRange

CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    request: Optional[int]      # the batch's sequence number
    parent: Optional[str]       # the enclosing span on the same thread
    thread: int                 # the OS thread id
    start_ns: int               # time.perf_counter_ns
    end_ns: int


class _Noop:
    """The span returned while nothing records: enters and leaves."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def profiler_running() -> bool:
    """Whether a torch profiler runs in this process (on any thread)."""
    return getattr(_profiler, "_is_profiler_enabled", False)


def offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), the smallest of a few
    reads: a `perf_counter_ns` reading plus this is on the profiler's
    clock."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


class _Live:
    __slots__ = ("rec", "name", "mirror", "parent", "start", "range")

    def __init__(self, rec: "Recorder", name: str, mirror: bool):
        self.rec, self.name, self.mirror = rec, name, mirror

    def __enter__(self):
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.range = None
        if profiler_running():
            self.range = (_profiler.record_function(self.name)
                          if self.mirror else _HostRange(self.name))
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        local = self.rec._local
        local.stack.pop()
        self.rec._ring.append(Span(
            self.name, getattr(local, "request", None), self.parent,
            threading.get_native_id(), self.start, end))
        return False


class Recorder:
    """A bounded ring of spans and the switch that makes them live."""

    def __init__(self, capacity: int = CAPACITY):
        self.enabled = False
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._local = threading.local()

    def _stack(self) -> list:
        local = self._local
        if not hasattr(local, "stack"):
            local.stack = []
        return local.stack

    def span(self, name: str, mirror: bool = False):
        """A context manager timing its block as span `name`; with
        `mirror`, its range under a profiler is mirrored on the device."""
        if not (self.enabled
                or getattr(_profiler, "_is_profiler_enabled", False)):
            return NOOP
        return _Live(self, name, mirror)

    def request(self, seq: Optional[int]) -> None:
        """Name the batch this thread works on (None: none)."""
        self._local.request = seq

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def spans(self) -> List[Span]:
        """The records in the ring, oldest first."""
        return list(self._ring)


RECORDER = Recorder()
span = RECORDER.span
request = RECORDER.request
enable = RECORDER.enable
disable = RECORDER.disable
spans = RECORDER.spans
