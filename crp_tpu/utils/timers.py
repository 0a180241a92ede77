"""Phase timers.

The reference wraps every pipeline stage in ``get_wtime_sec()`` pairs and
accumulates per-phase times in engine structs (``src/rowpara_spmm.h:33-39``).
Device dispatch is async, so a phase timer must fence with
``jax.block_until_ready`` to be meaningful; ``Timer.phase`` takes an optional
value to fence on.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


def get_wtime_sec() -> float:
    return time.perf_counter()


class Timer:
    """Accumulating named phase timer (seconds).

    Keeps both the running total per phase and the individual samples, so
    stat tables can print min/avg/max columns like the reference's
    ``MPI_Reduce`` MIN/SUM/MAX tables (``src/rowpara_spmm.c:425-464``) —
    across execs here, since phases are host-fenced wall clock.
    """

    def __init__(self) -> None:
        self.t = defaultdict(float)
        self.samples = defaultdict(list)
        self.n_exec = 0

    @contextmanager
    def phase(self, name: str, fence=None):
        st = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                try:
                    import jax
                except ImportError:
                    jax = None
                if jax is not None:
                    # device errors (OOM, DMA faults) must propagate — a
                    # swallowed failure here poisons downstream results
                    jax.block_until_ready(fence)
            dt = time.perf_counter() - st
            self.t[name] += dt
            self.samples[name].append(dt)

    def add(self, name: str, seconds: float) -> None:
        self.t[name] += seconds
        self.samples[name].append(seconds)

    def clear(self) -> None:
        """Reset accumulated stats (reference ``rp_spmm_clear_stat``)."""
        self.t.clear()
        self.samples.clear()
        self.n_exec = 0

    def avg(self, name: str) -> float:
        if self.n_exec == 0:
            return 0.0
        return self.t[name] / self.n_exec

    def min(self, name: str) -> float:
        s = self.samples.get(name)
        return min(s) if s else 0.0

    def max(self, name: str) -> float:
        s = self.samples.get(name)
        return max(s) if s else 0.0
