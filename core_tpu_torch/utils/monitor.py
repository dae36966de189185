"""Progress reporting (counterpart of core_tpu/utils/monitor.py; the
reference's progressBar_t, include/yafraycore/monitor.h:24-55).

render_image ticks a bar once per sample chunk: init(total chunks), then
update(1) after each chunk, then done().  ConsoleProgressBar draws the
reference's console bar; CallbackProgressBar drives a user callback (the
SWIG pyProgress, yafrayinterface.i:472-535).
"""
from __future__ import annotations

import sys


class ProgressBar:
    """Abstract progress sink (monitor.h:24-40)."""

    def init(self, total_steps: int = 100):
        self.total = max(1, total_steps)
        self.done_steps = 0

    def update(self, steps: int = 1):
        self.done_steps += steps

    def done(self):
        self.done_steps = self.total

    def set_tag(self, text: str):
        self.tag = text


class ConsoleProgressBar(ProgressBar):
    """80-column console bar (monitor.h ConsolePB)."""

    def __init__(self, width: int = 60, out=None):
        self.width = width
        self.out = out or sys.stdout
        self.tag = ""
        self.init(100)

    def _draw(self):
        frac = min(1.0, self.done_steps / self.total)
        n = int(self.width * frac)
        bar = "#" * n + "-" * (self.width - n)
        self.out.write(f"\r[{bar}] {100.0 * frac:5.1f}% {self.tag}")
        self.out.flush()

    def init(self, total_steps: int = 100):
        super().init(total_steps)
        self._draw()

    def update(self, steps: int = 1):
        super().update(steps)
        self._draw()

    def done(self):
        super().done()
        self._draw()
        self.out.write("\n")
        self.out.flush()


class CallbackProgressBar(ProgressBar):
    """Calls cb(done, total, tag) on every update and at done."""

    def __init__(self, cb):
        self.cb = cb
        self.tag = ""
        self.init(100)

    def update(self, steps: int = 1):
        super().update(steps)
        self.cb(self.done_steps, self.total, self.tag)

    def done(self):
        super().done()
        self.cb(self.done_steps, self.total, self.tag)
