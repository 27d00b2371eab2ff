"""Client futures and timers.

Copied unchanged from ``riak_ensemble_tpu/runtime.py`` (``Future`` and
``Timer``) — what the keyed service slice needs; the discrete-event
simulator itself stays with the scalar-plane slice.  The port keeps its
own copy so it imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, List


class Future:
    __slots__ = ("done", "value", "_waiters")

    def __init__(self) -> None:
        self.done = False
        self.value: Any = None
        self._waiters: List[Callable[[Any], None]] = []

    def resolve(self, value: Any) -> None:
        if self.done:
            return
        self.done = True
        self.value = value
        waiters, self._waiters = self._waiters, []
        # Every waiter runs even if an earlier one raises (the list is
        # already swapped out, so a skipped waiter could never fire);
        # the errors re-raise afterwards — all of them, as a group
        # when there are several — so no bug loses its signal.
        # KeyboardInterrupt/SystemExit abort immediately.
        errs: List[Exception] = []
        for w in waiters:
            try:
                w(value)
            except Exception as exc:
                errs.append(exc)
        if len(errs) == 1:
            raise errs[0]
        if errs:
            raise ExceptionGroup("future waiter errors", errs)

    def add_waiter(self, fn: Callable[[Any], None]) -> None:
        if self.done:
            fn(self.value)
        else:
            self._waiters.append(fn)


class Timer:
    __slots__ = ("cancelled", "fire_at")

    def __init__(self, fire_at: float) -> None:
        self.cancelled = False
        self.fire_at = fire_at

    def cancel(self) -> None:
        self.cancelled = True
