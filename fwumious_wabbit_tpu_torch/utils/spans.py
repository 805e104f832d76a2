"""Named spans of the port's host work, on the profiler's clock.

``span(name, counts, key)`` times one interval of a stage. While a
``torch.profiler`` records (the benchmark's traced pass, or
``--fwt_profile``), it opens a ``record_function`` range of that name,
which the Chrome trace exports on the clock of the device's kernels and
copies. Where ``counts`` is given, it adds the interval's ``perf_counter``
seconds to ``counts[key]`` whether or not a profiler records: one of the
loop's in-run counters (train/loop.py), so that a counter and its range
time the same interval. With no profiler recording, a span costs one flag
read, and the clock pair where it counts.

A range reaches only the profiler that is recording, and only from the
threads it records (by default the thread that started it). Names read
``fwt.<stage>.<what>`` and carry no number: the profiler exports no
argument of a range, and a trace is read by grouping names. No span goes
inside a function that a CUDA graph captures: a replay runs none of that
host code.
"""

from __future__ import annotations

import time

from torch.autograd import profiler as _profiler


class span:
    """One interval: ``with span(name, counts, key): ...``, or
    :meth:`open` and :meth:`close` where its ends lie in different
    functions. ``seconds`` is the last interval's length where it
    counts."""

    __slots__ = ("name", "counts", "key", "seconds", "_t0", "_range")

    def __init__(self, name: str, counts: dict | None = None, key: str | None = None):
        self.name, self.counts, self.key = name, counts, key
        self.seconds = 0.0
        self._t0 = self._range = None

    def open(self) -> "span":
        # read through the module: the profiler rebinds the flag
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        if self.counts is not None:
            self._t0 = time.perf_counter()
        return self

    def close(self) -> None:
        """End the interval; a span that is not open is left as it is."""
        if self._t0 is not None:
            self.seconds = time.perf_counter() - self._t0
            self._t0 = None
            self.counts[self.key] += self.seconds
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    __enter__ = open

    def __exit__(self, *exc) -> None:
        self.close()


_END = object()


def spanned(name: str, iterable):
    """The items of ``iterable``, the making of each (its ``next``) under a
    span ``name``."""
    it = iter(iterable)
    while True:
        with span(name):
            item = next(it, _END)
        if item is _END:
            return
        yield item
