"""What the host did over a measured window, logged on one line beside the
run's metrics, so that a run that reads far from the rest can be traced
to its host: this process's CPU seconds (user, system), and the garbage
collector's passes and pauses by generation."""

from __future__ import annotations

import gc
import resource
import time


class Watch:
    def __init__(self) -> None:
        self.pauses: list[tuple[int, float]] = []
        self._t = None

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"], time.perf_counter() - self._t))
            self._t = None

    def start(self) -> "Watch":
        self.t0, self.r0 = time.perf_counter(), resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._gc)
        return self

    def stop(self) -> str:
        gc.callbacks.remove(self._gc)
        wall = time.perf_counter() - self.t0
        r1, r0 = resource.getrusage(resource.RUSAGE_SELF), self.r0
        out = (f"window host: {wall:.3f} s; process user {r1.ru_utime - r0.ru_utime:.3f} s, "
               f"system {r1.ru_stime - r0.ru_stime:.3f} s")
        for g in range(3):
            ps = [p for gen, p in self.pauses if gen == g]
            if ps:
                out += f"; gc gen{g} {len(ps)} passes, {1e3 * sum(ps):.1f} ms, longest {1e3 * max(ps):.1f} ms"
        return out
