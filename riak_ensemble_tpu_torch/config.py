"""Configuration with derived-timeout hierarchy.

Copied unchanged from ``riak_ensemble_tpu/config.py`` (the ``Config``
dataclass and ``fast_test_config``); the port keeps its own copy so
it imports nothing of the JAX package.

Mirrors ``src/riak_ensemble_config.erl:27-130``.  The derivation chain
``tick < lease < follower_timeout < election_timeout`` is a correctness
constraint (a leader must refresh its lease well before followers give
up on it); overriding one knob re-derives the ones below it unless they
are explicitly pinned.

All durations are in **seconds** (the host runtime uses a monotonic
float-second clock, virtual in tests, ``CLOCK_BOOTTIME`` in production
via the C++ clock module).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # Primary ensemble tick: leader lease-refresh rate
    # (config.erl:27-28, default 500ms).
    ensemble_tick: float = 0.5

    # Leader lease duration; > tick, < follower_timeout
    # (config.erl:34-35, default 1.5x tick).
    lease_duration: Optional[float] = None

    # Whether leaders may serve reads locally inside an unexpired lease
    # (config.erl:41-42).  The batched service's lease-protected read
    # fast path honors this: False forces every read through a device
    # round.
    trust_lease: bool = True

    # Safety margin subtracted from the lease before a leader serves a
    # local read (the clock-skew guard of the lease argument): a fast
    # read is allowed only while now + margin < lease expiry, and the
    # inequality lease + margin < follower_timeout must hold — a
    # follower must outwait any read the leader could still be
    # serving.  Default tick/2 (well inside the 3x-lease headroom the
    # default derivation chain leaves).
    read_lease_margin: Optional[float] = None

    # How long a follower waits for leader commits before abandoning it
    # (config.erl:47-48, default 4x lease).
    follower_timeout: Optional[float] = None

    # Randomized election timeout base (config.erl:52-54: ft + U(0, ft)).
    # election_timeout() below applies the randomization.
    election_timeout_base: Optional[float] = None

    # Prefollow timeout: wait on a preliminary leader (config.erl:58-60).
    prefollow_timeout: Optional[float] = None

    # Pending timeout: peers not-yet-members wait in `pending` state
    # (config.erl:64-66, default 10x tick).
    pending_timeout: Optional[float] = None

    # Alive ticks: failed leader ticks tolerated before step-down
    # (config.erl:70-72 alive_tokens, default 2).
    alive_ticks: int = 2

    # Worker pool size per peer (config.erl:88-89, default 1).
    peer_workers: int = 1

    # Probe retry delay (config.erl:77-84, default 1s).
    probe_delay: float = 1.0

    # Coalesced fact storage: flush delay after first dirty write and
    # periodic tick (config.erl:94-101, 50ms / 5s).
    storage_delay: float = 0.05
    storage_tick: float = 5.0

    # Distrust synctrees on restart until an exchange completes
    # (config.erl:104-108).
    tree_validation: bool = True

    # Send follower synctree updates synchronously (config.erl:112-117).
    synchronous_tree_updates: bool = False

    # Extra wait for *all* responses before treating notfound as
    # authoritative — tombstone avoidance (config.erl:126-127, 1ms).
    notfound_read_delay: float = 0.001

    # Local backend op timeouts (peer.erl LOCAL_GET/PUT_TIMEOUT, 60s).
    local_get_timeout: float = 60.0
    local_put_timeout: float = 60.0

    # Quorum vote-collection timeout (msg.erl:95,235 = tick).
    quorum_timeout: Optional[float] = None

    # K/V client-facing request timeout (peer.erl ?REQUEST_TIMEOUT 30s).
    request_timeout: float = 30.0

    # Gossip tick for the cluster manager (manager.erl:569-573, 2s).
    gossip_tick: float = 2.0

    # Routers per node (router.erl:163-170). The host runtime has no
    # process-mailbox bottleneck, kept for parity/introspection.
    routers: int = 7

    # -- derived accessors ------------------------------------------------

    def lease(self) -> float:
        return self.lease_duration if self.lease_duration is not None \
            else self.ensemble_tick * 1.5

    def follower(self) -> float:
        return self.follower_timeout if self.follower_timeout is not None \
            else self.lease() * 4

    def read_margin(self) -> float:
        return self.read_lease_margin \
            if self.read_lease_margin is not None \
            else self.ensemble_tick * 0.5

    def election_timeout(self, rng: random.Random) -> float:
        base = self.election_timeout_base if self.election_timeout_base is not None \
            else self.follower()
        return base + rng.uniform(0, base)

    def prefollow(self) -> float:
        return self.prefollow_timeout if self.prefollow_timeout is not None \
            else self.ensemble_tick * 2

    def pending(self) -> float:
        return self.pending_timeout if self.pending_timeout is not None \
            else self.ensemble_tick * 10

    def quorum(self) -> float:
        return self.quorum_timeout if self.quorum_timeout is not None \
            else self.ensemble_tick

    def validate(self) -> None:
        """Assert the timeout hierarchy invariant."""
        assert self.ensemble_tick < self.lease() < self.follower(), (
            "config invariant violated: need tick < lease < follower_timeout "
            f"got {self.ensemble_tick} / {self.lease()} / {self.follower()}"
        )
        # The lease-read safety inequality: a leader may serve a local
        # read up to (lease - margin) after its last quorum contact,
        # and a follower elects only after follower_timeout of leader
        # silence — lease + margin < follower_timeout keeps every
        # possible leased read strictly inside the followers' patience
        # even under clock skew up to the margin.  Only binding when
        # leased reads are possible at all (trust_lease): an opted-out
        # config never serves around the quorum round and keeps the
        # pre-existing construction contract.
        assert not self.trust_lease or (
            0.0 <= self.read_margin() and
            self.lease() + self.read_margin() < self.follower()), (
            "config invariant violated: need lease + read_margin < "
            f"follower_timeout, got {self.lease()} + {self.read_margin()}"
            f" vs {self.follower()}"
        )


#: Test-friendly config: 10x faster than production defaults so virtual-
#: time integration tests converge in a few simulated seconds.
def fast_test_config() -> Config:
    return Config(ensemble_tick=0.05, probe_delay=0.1, storage_delay=0.005,
                  storage_tick=0.5, gossip_tick=0.2)
