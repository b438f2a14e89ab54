"""Phase timer (reference: src/timer.h:40-110)."""
from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._start = 0.0
        self._total = 0.0
        self._running = False

    def start(self):
        self._start = time.perf_counter()
        self._running = True

    def stop(self):
        if self._running:
            self._total += time.perf_counter() - self._start
            self._running = False

    def reset(self):
        self._total = 0.0
        self._running = False

    def seconds(self) -> float:
        t = self._total
        if self._running:
            t += time.perf_counter() - self._start
        return t

    def milliseconds(self) -> float:
        return self.seconds() * 1000.0

    def minutes(self) -> float:
        return self.seconds() / 60.0
