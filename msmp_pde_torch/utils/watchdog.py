"""Training-stall watchdog: detect a wedged device mid-run and recover (a
copy of msmp_pde_tpu/utils/watchdog.py: the port imports nothing of the
JAX package).

``Watchdog`` is a daemon thread that fires an ``action`` when no
``beat()`` arrives for ``stall_s`` seconds. The train CLI beats at every
loss print and metric return, and its action re-execs the process with
``--resume <last checkpoint>`` (training/train.py), so a hung run loses
at most ``stall_s`` and the epochs since its last best-val checkpoint.
``os.execv`` works from the watchdog thread even while the main thread is
stuck in a C call.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class Watchdog:
    """Fire ``action`` if no beat() arrives for ``stall_s`` seconds.

    stall_s <= 0 disables (start() is a no-op). The check interval is
    stall_s/8 capped at 30 s, so firing is at most ~12% late. ``action``
    runs on the watchdog thread exactly once; stop() disarms.
    """

    def __init__(self, stall_s: float, action: Callable[[], None],
                 log: Callable[[str], None] = print):
        self.stall_s = float(stall_s)
        self._action = action
        self._log = log
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self.stall_s <= 0 or self._thread is not None:
            return self
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="msmp-watchdog", daemon=True)
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    def _run(self):
        interval = min(30.0, self.stall_s / 8.0)
        while not self._stop.wait(interval):
            stalled = time.monotonic() - self._last
            if stalled > self.stall_s:
                self._log(
                    f"WATCHDOG: no training progress for {stalled:.0f}s "
                    f"(> {self.stall_s:.0f}s) — device presumed hung; "
                    "recovering")
                try:
                    self._action()
                finally:
                    return
