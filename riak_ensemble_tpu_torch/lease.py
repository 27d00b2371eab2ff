"""Leader lease on a monotonic clock.

Copied from ``riak_ensemble_tpu/lease.py`` with its imports pointed at
this package, so the port imports nothing of the JAX package.

Mirrors ``src/riak_ensemble_lease.erl``: the lease records an expiry in
monotonic milliseconds; ``check_lease`` compares against the monotonic
clock (never wall-clock, which can jump — rationale lease.erl:26-50).
The leader refreshes each tick (peer tick chain) and releases on
step-down.

The clock source is injected: virtual runtime clock in simulation, the
C++ ``CLOCK_BOOTTIME`` module (:mod:`riak_ensemble_tpu_torch.utils.clock`) in
production.
"""

from __future__ import annotations

from typing import Callable, Optional


class Lease:
    def __init__(self, clock: Callable[[], float]) -> None:
        self._clock = clock
        self._expiry: Optional[float] = None

    def lease(self, duration: float) -> None:
        """Grant/renew for `duration` seconds (lease.erl:63-67)."""
        self._expiry = self._clock() + duration

    def unlease(self) -> None:
        """Release (lease.erl:69-73)."""
        self._expiry = None

    def check_lease(self, margin: float = 0.0) -> bool:
        """lease.erl:76-88.  ``margin`` is the clock-skew guard the
        lease-protected read fast path subtracts before trusting the
        lease (Config.read_margin — the scalar analog of the batched
        service's vectorized ``lease_until`` check): the lease is
        only trusted while ``clock + margin < expiry``."""
        return self._expiry is not None \
            and self._clock() + margin < self._expiry
