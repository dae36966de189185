"""Named-event wall-clock timer (counterpart of core_tpu/utils/timer.py;
the reference's gTimer, include/yafraycore/timer.h:33-42): start / stop /
get_time around render phases, and a module-level singleton."""
from __future__ import annotations

import contextlib
import time


class Timer:
    def __init__(self):
        self._events: dict[str, float] = {}
        self._starts: dict[str, float] = {}

    def start(self, name: str):
        self._starts[name] = time.perf_counter()

    def stop(self, name: str):
        if name in self._starts:
            self._events[name] = self._events.get(name, 0.0) \
                + time.perf_counter() - self._starts.pop(name)

    def get_time(self, name: str) -> float:
        return self._events.get(name, 0.0)

    def events(self):
        return list(self._events.items())

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)


timer = Timer()   # module-level singleton like the reference's gTimer
