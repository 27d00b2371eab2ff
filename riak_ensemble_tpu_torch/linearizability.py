"""Linearizability checking harness — the sc.erl analog.

Copied from ``riak_ensemble_tpu/linearizability.py`` with its imports
pointed at this package, so the port imports nothing of the JAX package:
:class:`Workload` drives the port's ``router`` and ``peer`` verbs, and
:class:`ServiceReadWorkload` the port's
:class:`.parallel.batched_host.BatchedEnsembleService`.

The reference's real consistency test (``test/sc.erl``, 1071 LoC EQC
statem) drives random concurrent kget/kover/kput_once/kupdate/kdelete
from N workers against a live cluster, injects partitions/heals, and
checks postconditions: every acked write is observed, reads return a
plausible value, and acked data is never lost ("Data loss!" check,
sc.erl:835-880; read postcondition sc.erl:112-148).

This module re-creates that as a deterministic virtual-time harness:

- :class:`KeyModel` — per-key set of *plausible current values*.  An
  acked write fixes the state to its value (plus any still-in-flight
  concurrent writes, which may legally serialize after it).  A
  timed-out write MAY have applied (now or once its queued put reaches
  quorum), so its value joins the plausible set.  A CAS-failed write
  did not apply.  A successful read both validates against and
  re-pins the plausible set — that is the linearizable-read property.
- :class:`Workload` — N sequential workers (runtime tasks) issuing a
  random op mix through the real router/client path, a nemesis
  schedule (peer suspensions; node partitions healed before checking),
  and the final quiesced read-back verifying no acked write was lost.

Any violation raises :class:`Violation` with the offending history
tail for debugging.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from riak_ensemble_tpu_torch import funref
from riak_ensemble_tpu_torch import router as routerlib
from riak_ensemble_tpu_torch.peer import do_kput_once, do_kupdate
from riak_ensemble_tpu_torch.runtime import Runtime
from riak_ensemble_tpu_torch.types import NOTFOUND, Obj, PeerId

_op_ids = itertools.count(1)


class Violation(AssertionError):
    pass


def _val(v: Any) -> Any:
    """Hashable value token (NOTFOUND is a singleton already)."""
    return v


@dataclass
class _Inflight:
    op_id: int
    value: Any


@dataclass
class KeyModel:
    """Plausible-current-value tracking for one key (the sc.erl
    possible-values postcondition model).

    Three tiers of uncertainty:
    - ``possible`` — values the key may hold given every *completed*
      op (acked writes pin it, plus still-in-flight concurrent writes
      that may serialize after the pin);
    - ``inflight`` — invoked-but-unresponded writes;
    - ``maybe`` — writes that TIMED OUT.  An op with no response has
      no linearization upper bound: it may take effect at ANY later
      point (e.g. a delete queued behind a suspended leader applies
      after that peer wins a later election — observed under the
      freeze/partition nemesis), so these stay plausible indefinitely.
      True data loss is still caught whenever the key has no
      unresolved timeout that could explain the observation.
    """

    key: Any
    possible: Set[Any] = field(default_factory=lambda: {NOTFOUND})
    inflight: Dict[int, _Inflight] = field(default_factory=dict)
    maybe: Set[Any] = field(default_factory=set)
    history: List[Tuple] = field(default_factory=list)

    def _inflight_values(self, exclude: Optional[int] = None) -> Set[Any]:
        return {w.value for w in self.inflight.values()
                if w.op_id != exclude}

    def invoke_write(self, value: Any) -> int:
        op_id = next(_op_ids)
        self.inflight[op_id] = _Inflight(op_id, _val(value))
        self.history.append(("invoke", op_id, value))
        return op_id

    def ack_write(self, op_id: int) -> None:
        w = self.inflight.pop(op_id)
        # Linearization point inside the op window: state is now w's
        # value; in-flight concurrent writes may serialize after it.
        # (An earlier-completed read's pinned value X stays plausible
        # only if something could make X current after this write —
        # an in-flight or timed-out write of X, which `inflight`/
        # `maybe` already cover.  MODEL ASSUMPTION: read results are
        # fed to ack_read in a serialization-consistent order — a read
        # must not be reported after an overlapping write's ack if it
        # linearized before that write.  Both harness drivers satisfy
        # this: the batched service resolves in device round order and
        # the actor stack serializes same-key ops through one worker.)
        self.possible = {w.value} | self._inflight_values()
        self.history.append(("ack", op_id, w.value))

    def fail_write(self, op_id: int) -> None:
        """CAS precondition failure — op did NOT apply (sc.erl treats
        {error,failed} CAS results as no-ops)."""
        self.inflight.pop(op_id, None)
        self.history.append(("failed", op_id))

    def timeout_write(self, op_id: int) -> None:
        """Outcome unknown: may have applied, or may apply at any
        later point — stays plausible until observed."""
        w = self.inflight.pop(op_id)
        self.maybe.add(w.value)
        self.history.append(("timeout", op_id, w.value))

    def ack_read(self, value: Any) -> None:
        value = _val(value)
        valid = self.possible | self._inflight_values() | self.maybe
        if value not in valid:
            what = ("DATA LOSS (notfound read, but a write must be "
                    "visible)" if value is NOTFOUND else "stale/phantom "
                    "read")
            raise Violation(
                f"{what} of {self.key!r}: returned {value!r}; plausible "
                f"was {valid!r}\nhistory tail: {self.history[-12:]}")
        # A linearizable read pins the state (timed-out writes may
        # still land later, so `maybe` persists).
        self.possible = {value} | self._inflight_values()
        self.history.append(("read", value))


@dataclass
class CounterModel:
    """Convergence model for a key driven ONLY by commutative device
    RMWs (rmw:add / rmw:sub) — the §18 commutative-lane sweeps.

    Per-op sequencing is invisible in the final value, so the whole
    history collapses to one obligation: the final counter must equal
    the int32-wraparound sum of every ACKED operand plus SOME subset
    of the AMBIGUOUS operands (timeouts / ambiguous disconnects — each
    may have applied at most once), starting from the initial value.
    This catches both failure modes the lane could introduce: a
    double-apply (a merged or retried op counted twice — the final
    overshoots every reachable sum) and early-ack loss (an acked op
    missing after a crash/handoff — the final undershoots).

    The reachable-sum set is 2^len(ambiguous); keep ambiguity rare
    (the sweeps inject a handful of kills, not thousands)."""

    key: Any
    initial: int = 0
    acked_sum: int = 0
    n_acked: int = 0
    ambiguous: List[int] = field(default_factory=list)

    def ack(self, operand: int) -> None:
        """An acked rmw:add of ``operand`` (sub acks negated)."""
        self.acked_sum = funref.i32(self.acked_sum + int(operand))
        self.n_acked += 1

    def unknown(self, operand: int) -> None:
        """An op whose outcome is ambiguous (timeout, dropped
        mid-ack): it applied once or not at all — never twice."""
        self.ambiguous.append(int(operand))

    def check_final(self, final: int) -> None:
        reach = {funref.i32(self.initial + self.acked_sum)}
        for op in self.ambiguous:
            reach |= {funref.i32(v + op) for v in reach}
        if funref.i32(int(final)) not in reach:
            raise Violation(
                f"counter {self.key!r} diverged: final {final!r} not "
                f"reachable from initial {self.initial} + "
                f"{self.n_acked} acked ops (sum {self.acked_sum}) + "
                f"any subset of ambiguous {self.ambiguous!r}")


class Workload:
    """Concurrent random workload + nemesis against one ensemble."""

    OPS = ("kget", "kover", "kput_once", "kupdate", "kdelete")

    def __init__(self, mc, ensemble: Any, n_workers: int = 3,
                 n_keys: int = 4, ops_per_worker: int = 60,
                 op_timeout: float = 8.0, seed: int = 0,
                 nemesis_hold: Tuple[float, float] = (0.3, 1.5),
                 member_churn: bool = False,
                 oneway_partitions: bool = False) -> None:
        import random

        self.mc = mc
        self.runtime: Runtime = mc.runtime
        self.ensemble = ensemble
        self.rng = random.Random(seed)
        self.keys = [f"k{i}" for i in range(n_keys)]
        self.models: Dict[Any, KeyModel] = {k: KeyModel(k)
                                            for k in self.keys}
        self.n_workers = n_workers
        self.ops_per_worker = ops_per_worker
        self.op_timeout = op_timeout
        self.done = 0
        self.nemesis_hold = nemesis_hold
        self.member_churn = member_churn
        #: opt-in ONE-DIRECTIONAL partitions (the sc.erl fault mode
        #: never ported before the fault plane: A→B delivers, B→A
        #: drops — the classic failover killer).  Opt-in so the
        #: pre-existing seeded sweeps keep their exact schedules.
        self.oneway_partitions = oneway_partitions
        self.op_counts: Dict[str, int] = {}
        self.violations: List[Violation] = []

    # -- op plumbing -------------------------------------------------------

    def _sync(self, node, event):
        return routerlib.sync_send_event_fut(
            self.runtime, node, self.ensemble, event, self.op_timeout)

    def _worker(self, widx: int):
        nodes = list(self.mc.managers)
        last_read: Dict[Any, Obj] = {}
        for _ in range(self.ops_per_worker):
            key = self.rng.choice(self.keys)
            node = self.rng.choice(nodes)
            op = self.rng.choice(self.OPS)
            model = self.models[key]
            self.op_counts[op] = self.op_counts.get(op, 0) + 1
            try:
                if op == "kget":
                    result = yield self._sync(node, ("get", key, ()))
                    if isinstance(result, tuple) and result[0] == "ok":
                        last_read[key] = result[1]
                        model.ack_read(result[1].value)
                elif op == "kupdate":
                    cur = last_read.get(key)
                    if cur is None:
                        continue
                    value = f"w{widx}-{self.rng.randrange(10**6)}".encode()
                    op_id = model.invoke_write(value)
                    result = yield self._sync(
                        node, ("put", key, do_kupdate, [cur, value]))
                    self._settle_write(model, op_id, result)
                elif op == "kput_once":
                    value = f"p{widx}-{self.rng.randrange(10**6)}".encode()
                    op_id = model.invoke_write(value)
                    result = yield self._sync(
                        node, ("put", key, do_kput_once, [value]))
                    self._settle_write(model, op_id, result)
                elif op == "kdelete":
                    op_id = model.invoke_write(NOTFOUND)
                    result = yield self._sync(
                        node, ("overwrite", key, NOTFOUND))
                    self._settle_write(model, op_id, result)
                else:  # kover
                    value = f"o{widx}-{self.rng.randrange(10**6)}".encode()
                    op_id = model.invoke_write(value)
                    result = yield self._sync(
                        node, ("overwrite", key, value))
                    self._settle_write(model, op_id, result)
            except Violation as v:
                self.violations.append(v)
                break
            # Think time stretches the workload across many nemesis
            # windows (ops are ~ms in virtual time; without this the
            # whole run fits between two nemesis actions).
            yield self.runtime.sleep(self.rng.uniform(0.05, 0.3))
        self.done += 1

    @staticmethod
    def _is_ok(result) -> bool:
        return isinstance(result, tuple) and result[0] == "ok"

    def _settle_write(self, model: KeyModel, op_id: int, result) -> None:
        if self._is_ok(result):
            model.ack_write(op_id)
        elif result == "failed":
            model.fail_write(op_id)
        else:  # timeout / unavailable: outcome unknown
            model.timeout_write(op_id)

    # -- nemesis -----------------------------------------------------------

    def _member_churn(self, spare):
        """One add→remove membership cycle through the real
        update_members path, concurrent with the workload (the
        replace_members-under-load scenario)."""
        for changes in ((("add", spare),), (("del", spare),)):
            r = yield routerlib.sync_send_event_fut(
                self.runtime, spare.node, self.ensemble,
                ("update_members", changes), 10.0)
            # a failed/raced change is fine — the next cycle retries;
            # what must hold is the workload's consistency
            yield self.runtime.sleep(self.rng.uniform(0.5, 1.5))

    def _nemesis(self, duration: float, partitions: bool):
        members = list(self.mc.mgr(self.mc.node0).get_members(
            self.ensemble)) or []
        nodes = sorted({m.node for m in members})
        spare_n = 0
        end = self.runtime.now + duration
        while self.runtime.now < end and self.done < self.n_workers:
            action = self.rng.random()
            lo, hi = self.nemesis_hold
            if self.member_churn and action < 0.25 and nodes:
                spare = PeerId(1000 + spare_n, self.rng.choice(nodes))
                spare_n += 1
                yield from self._member_churn(spare)
            elif action < 0.5 and members:
                # freeze a random peer (suspend_process analog)
                victim = self.rng.choice(members)
                self.mc.suspend_peer(self.ensemble, victim)
                yield self.runtime.sleep(self.rng.uniform(lo, hi))
                self.mc.resume_peer(self.ensemble, victim)
            elif self.oneway_partitions and partitions \
                    and len(nodes) >= 3 and action < 0.75:
                # ONE-DIRECTIONAL cut (fault plane): the victim
                # either goes deaf (inbound dropped: it keeps
                # sending — acks, votes, heartbeats — but hears
                # nothing) or mute (outbound dropped: it receives
                # the cluster's traffic but every reply vanishes).
                # Either asymmetry must serialize exactly like the
                # symmetric cut: a leader that can reach clients but
                # not its quorum must stop acking.
                victim = self.rng.choice(nodes)
                rest = [n for n in nodes if n != victim]
                if self.rng.random() < 0.5:
                    self.runtime.net.partition_oneway([victim], rest)
                else:
                    self.runtime.net.partition_oneway(rest, [victim])
                yield self.runtime.sleep(self.rng.uniform(lo, 2 * hi))
                self.runtime.net.heal()
            elif partitions and len(nodes) >= 3:
                # cut off a minority node (sc.erl partition_nodes)
                victim = self.rng.choice(nodes)
                rest = [n for n in nodes if n != victim]
                self.runtime.net.partition([victim], rest)
                yield self.runtime.sleep(self.rng.uniform(lo, 2 * hi))
                self.runtime.net.heal()
            yield self.runtime.sleep(self.rng.uniform(0.1, 0.5))
        self.runtime.net.heal()

    # -- run ---------------------------------------------------------------

    def run(self, max_virtual: float = 600.0,
            partitions: bool = True) -> None:
        for w in range(self.n_workers):
            self.runtime.spawn_task(self._worker(w), name=f"sc-worker{w}")
        self.runtime.spawn_task(self._nemesis(max_virtual, partitions),
                                name="sc-nemesis")
        ok = self.runtime.run_until(
            lambda: self.done >= self.n_workers or self.violations,
            max_time=max_virtual, poll=0.5)
        if self.violations:
            raise self.violations[0]
        if not ok:
            raise Violation("workload did not finish in virtual budget")
        self._final_check()

    def _final_check(self) -> None:
        """Quiesced read-back: heal everything, then every key must
        read back a plausible value (no acked write lost)."""
        self.runtime.net.heal()
        self.mc.wait_stable(self.ensemble, max_time=120.0)
        client = self.mc.client(self.mc.node0)
        for key in self.keys:
            model = self.models[key]

            def read_ok(key=key, model=model):
                r = client.kget(self.ensemble, key, timeout=5.0)
                if not self._is_ok(r):
                    return False
                model.ack_read(r[1].value)
                return True
            if not self.runtime.run_until(read_ok, 60.0, poll=0.5):
                raise Violation(f"final read of {key!r} never succeeded")


class ServiceReadWorkload:
    """Read-heavy workload + nemesis for the BATCHED SERVICE's
    lease-protected read fast path (batched_host §9): random
    concurrent kput/kdelete/kget against a
    :class:`~riak_ensemble_tpu_torch.parallel.batched_host.BatchedEnsembleService`
    on the virtual clock, checked against :class:`KeyModel`.

    The nemesis schedule targets exactly the hazards the fast path
    introduces:

    - **lease expiry mid-workload** — virtual-time jumps past the
      lease horizon, so reads race renewal and must fall back to the
      device round rather than serve a lapsed mirror;
    - **leader step-down / re-election** — the current leader's up
      flag drops right before the carrying flush (the election folds
      into the same launch); a later heal re-elects.  Fast reads must
      refuse leaderless/electing rows, and the post-election epoch
      bump must invalidate the vsn mirror rather than hand out stale
      CAS tokens;
    - **skewed-margin clock** — sub-lease jumps that land the clock
      INSIDE the safety margin ``[lease - margin, lease)``, the
      region where a skew-prone implementation would still serve; the
      margin must refuse there.

    Fast reads resolve synchronously at submit — their linearization
    point — so their model events apply immediately; queued ops apply
    in resolution (device-round) order after the drain, preserving
    the KeyModel's serialization-consistency assumption (a fast read
    of a key with any pending write is impossible by construction:
    the per-slot pending-write gate routes it to the round).

    Raises :class:`Violation` on any stale or lost read; the caller
    asserts coverage via the service's ``read_fastpath_hits`` /
    ``read_fastpath_misses`` counters.
    """

    def __init__(self, svc, runtime, n_keys: int = 3,
                 rounds: int = 40, seed: int = 0,
                 read_frac: float = 0.7) -> None:
        import random

        self.svc = svc
        self.runtime = runtime
        self.rng = random.Random(seed)
        self.rounds = rounds
        self.read_frac = read_frac
        self.keys = [f"k{i}" for i in range(n_keys)]
        self.models: Dict[Any, KeyModel] = {
            (e, k): KeyModel(f"{e}/{k}")
            for e in range(svc.n_ens) for k in self.keys}
        self.down: Dict[int, int] = {}
        self._vals = itertools.count(1)

    # -- nemesis arms --------------------------------------------------------

    def _nemesis(self) -> None:
        svc, rng = self.svc, self.rng
        r = rng.random()
        cfg = svc.config
        if r < 0.2 and self.down:
            # heal a downed leader: the next flush re-elects (the
            # step-down → re-election cycle completes)
            e = rng.choice(list(self.down))
            svc.set_peer_up(e, self.down.pop(e), True)
        elif r < 0.45:
            # step-down: kill the CURRENT leader right before the
            # flush that carries this round's ops
            e = rng.randrange(svc.n_ens)
            if e not in self.down and svc.leader_np[e] >= 0:
                p = int(svc.leader_np[e])
                svc.set_peer_up(e, p, False)
                self.down[e] = p
        elif r < 0.65:
            # lease expiry mid-workload: jump the clock past every
            # lease so the next reads race renewal
            self.runtime.run_for(cfg.lease() * 2.5)
        elif r < 0.85:
            # skewed-margin clock: land INSIDE [lease - margin,
            # lease) of the freshest grant — a correct margin check
            # refuses to serve there even though the lease itself has
            # not lapsed
            horizon = float(svc.lease_until.max()) - self.runtime.now
            if horizon > 0:
                skew = cfg.read_margin() * rng.uniform(0.0, 1.0)
                self.runtime.run_for(max(0.0, horizon - skew))

    # -- one round -----------------------------------------------------------

    def _submit(self):
        svc, rng = self.svc, self.rng
        pending = []
        for _ in range(rng.randrange(3, 9)):
            e = rng.randrange(svc.n_ens)
            key = rng.choice(self.keys)
            m = self.models[(e, key)]
            r = rng.random()
            if r < self.read_frac:
                fut = svc.kget(e, key)
                if fut.done:
                    # fast path (or immediate NOTFOUND): linearizes
                    # NOW — apply the model event at the serve point
                    if isinstance(fut.value, tuple) \
                            and fut.value[0] == "ok":
                        m.ack_read(fut.value[1])
                else:
                    pending.append(("get", m, None, fut))
            elif r < self.read_frac + 0.25 * (1 - self.read_frac):
                op_id = m.invoke_write(NOTFOUND)
                fut = svc.kdelete(e, key)
                if fut.done:  # no slot: immediate ack of NOTFOUND
                    m.ack_write(op_id)
                else:
                    pending.append(("del", m, op_id, fut))
            else:
                val = f"v{next(self._vals)}".encode()
                op_id = m.invoke_write(val)
                fut = svc.kput(e, key, val)
                if fut.done and fut.value == "failed":
                    m.fail_write(op_id)
                else:
                    pending.append(("put", m, op_id, fut))
        return pending

    def _drain(self, pending, max_flushes: int = 30) -> None:
        for _ in range(max_flushes):
            if all(f.done for *_x, f in pending):
                return
            self.svc.flush()
            self.runtime.run_for(0.001)
        raise Violation("service ops never resolved")

    @staticmethod
    def _apply(pending) -> None:
        for kind, m, op_id, fut in pending:
            r = fut.value
            ok = isinstance(r, tuple) and r[0] == "ok"
            if kind == "get":
                if ok:
                    m.ack_read(r[1])
            elif ok:
                m.ack_write(op_id)
            else:
                # the engine gates every replica write on the round's
                # quorum commit: 'failed' is a definitive no-op
                m.fail_write(op_id)

    def run(self) -> None:
        for _ in range(self.rounds):
            self._nemesis()
            pending = self._submit()
            self._drain(pending)
            self._apply(pending)
        # quiesce: heal, fold elections in, read every key back
        for e, p in list(self.down.items()):
            self.svc.set_peer_up(e, p, True)
        self.down.clear()
        self.svc.flush()
        pending = []
        for (e, key), m in self.models.items():
            fut = self.svc.kget(e, key)
            if fut.done:
                if isinstance(fut.value, tuple) \
                        and fut.value[0] == "ok":
                    m.ack_read(fut.value[1])
            else:
                pending.append(("get", m, None, fut))
        self._drain(pending)
        self._apply(pending)
