"""The card's SM clock, power draw and temperature, sampled every 250 ms
through the window by one ``nvidia-smi`` process the harness starts and
stops."""

from __future__ import annotations

import shutil
import subprocess
import threading
import time
from typing import List, Tuple

QUERY = "clocks.sm,power.draw,temperature.gpu"


class ClockSampler:
    """``samples``: (host seconds, SM MHz, power W, temperature C). Without
    ``nvidia-smi`` (a CPU run) there are none."""

    def __init__(self, index: int = 0, period_ms: int = 250):
        self.samples: List[Tuple[float, float, float, float]] = []
        self._cmd = ["nvidia-smi", f"--query-gpu={QUERY}",
                     "--format=csv,noheader,nounits", "-i", str(index),
                     "-lms", str(period_ms)]
        self._proc = None
        self._thread = None

    def start(self) -> "ClockSampler":
        if shutil.which("nvidia-smi") is None:
            return self
        self._proc = subprocess.Popen(self._cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                vals = [float(x) for x in line.split(",")]
            except ValueError:
                continue
            if len(vals) == 3:
                self.samples.append((time.perf_counter(), *vals))

    def stop(self) -> None:
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._thread.join(timeout=10)
        self._proc = None

    def between(self, t0: float, t1: float):
        return [s for s in self.samples if t0 <= s[0] <= t1]
