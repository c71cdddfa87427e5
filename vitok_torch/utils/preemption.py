"""Preemption-aware training: latch the signal, save at a step boundary.

Port of ``vitok_tpu/utils/preemption.py``. Schedulers deliver SIGTERM before
they take a machine away; the guard turns it (and Ctrl-C) into a flag the
training loop polls, so the loop writes a final checkpoint instead of
losing up to ``save_freq`` steps.

    guard = PreemptionGuard()
    for step in ...:
        state, metrics = train_step(...)
        if guard.should_stop:
            save_checkpoint(state, ckpt_dir)
            break
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Iterable, Optional


class PreemptionGuard:
    """Latches SIGTERM/SIGINT into a flag the training loop polls.

    Polling (rather than saving inside the signal handler) keeps checkpoint
    writes off the asynchronous signal path: the loop saves at a step
    boundary.
    """

    def __init__(
        self,
        signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT),
        on_preempt: Optional[Callable[[], None]] = None,
    ):
        self._stop = threading.Event()
        self._on_preempt = on_preempt
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass  # not the main thread, or an unsupported signal

    def _handler(self, signum, frame):
        self._stop.set()
        if self._on_preempt is not None:
            self._on_preempt()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


__all__ = ["PreemptionGuard"]
