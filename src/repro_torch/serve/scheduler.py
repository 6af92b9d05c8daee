"""Deadline-aware admission scheduling for the streaming topo engine.

A copy of ``repro.serve.scheduler`` (the port imports nothing from
``repro``: ``import repro.serve.scheduler`` would run
``repro/serve/__init__.py``, which imports JAX).

The paper's digital-twin workload is a continuous arrival process: each
monitoring event ships a load case with a freshness deadline ("the
updated design must reflect this load within D seconds"), not a batch to
drain. This module provides the policy half of that serving story —
serve/topo_service.py owns the slots, serve/gateway.py owns the routing,
this owns the queues:

  * ``EDFScheduler`` — a thread-safe earliest-deadline-first admission
    queue. Entries are ordered by (priority, effective deadline,
    admission sequence number): a higher ``priority`` outranks any
    deadline (the gateway's ``submit(..., priority=...)`` lane for
    must-run work), and the sequence number makes tie-breaking
    deterministic (equal ranks pop in submit order), which the
    bitwise-invariance test suite relies on. A deadline-less entry is
    given an *effective* deadline of ``submit + starvation_horizon``, so
    an unbounded stream of deadline-carrying arrivals can delay it by at
    most the horizon — EDF without the horizon starves best-effort work
    forever.

  * ``BoundedEDFScheduler`` — the gateway-level backpressure half: the
    same queue with a capacity bound and a pluggable
    ``types.OverloadPolicy`` deciding what ``offer()`` does when full —
    BLOCK (wait for the dispatcher to make room), REJECT (raise
    ``QueueFull``), or SHED_LATEST_DEADLINE (evict the lowest-ranked
    queued entry — latest effective deadline after priority — so the
    urgent traffic keeps its deadlines; under sustained overload this
    converts "everything finishes late" into "the feasible subset
    finishes on time"). ``pop_ready`` pops the best entry that a
    predicate accepts, so the dispatcher can skip meshes whose engine is
    at depth without head-of-line blocking the others.

  * ``preempt_victim`` — the slack-based preemption decision, kept a
    pure function of (candidate, slot views, clock, step-time estimate)
    so it can be unit-tested without threads or devices. A slot occupant
    may be evicted for a queue-head about to miss its deadline, but ONLY
    when the eviction provably cannot make the victim itself miss: the
    victim must still meet its own deadline after waiting out the
    candidate's remaining iterations. Evicted state is parked by the
    engine (lane gather) and re-admitted through the same queue with its
    original deadline and sequence number, so a parked request resumes
    exactly where EDF places it.

  * ``target_slots`` / ``ladder_rungs`` / ``rung_for`` — the pure
    elasticity policies. ``target_slots`` maps an observed per-bucket
    arrival rate to a slot width (clamped, even). On a ladder-less
    engine it is applied at bucket build / post-eviction rebuild (the
    only points where a compiled step's shape may change there); a
    ladder engine instead consumes it LIVE — the gateway feeds it to
    ``TopoServingEngine.set_target_slots`` each maintenance pass and
    the engine snaps it to a precompiled rung (``rung_for``), so width
    changes are a per-tick dispatch choice, never a rebuild.

  * ``shape_class_for`` — the mesh shape-class routing policy: map a
    request's exact ``(nelx, nely)`` onto the smallest canonical class
    that contains it, so the gateway's compile cache grows with
    ``len(ladder) x len(shape_classes)`` instead of with the fleet
    (requests are padded with passive borders, ``fea2d.pad_problem``).

Engine integration contract: the scheduler's condition variable
(``cond``) is the single lock for queue state. ``push``/``pop``/``peek``
take it internally (it is reentrant), and the engine's tick loop holds
it across compound peek-decide-pop sequences so admission decisions are
atomic with respect to concurrent ``submit`` calls.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.types import OverloadPolicy, QueueFull

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SlotView:
    """What the preemption decision needs to know about an occupied lane."""
    deadline: float          # absolute; INF when the occupant has none
    iters_left: int          # remaining iteration budget
    preemptible: bool = True  # engine clears this e.g. right after admission


def preempt_victim(deadline: float, iters_needed: int,
                   slots: Sequence[Optional[SlotView]], now: float,
                   sec_per_iter: float) -> Optional[int]:
    """Pick the lane to evict for a queue-head candidate, or None.

    Fires only when BOTH hold:
      * waiting for the next natural slot completion would make the
        candidate miss its deadline (so preemption is the only way), and
      * some preemptible occupant still meets its own deadline after
        parking behind the candidate (eviction cannot miss the victim's
        deadline).
    Among safe victims, the one with the most post-eviction slack is
    chosen; ties break to the lowest lane index (determinism).

    ``slots`` may contain None entries (empty lanes) — an empty lane
    means admission needs no preemption, so the answer is None.
    """
    if deadline == INF or sec_per_iter <= 0.0:
        return None  # deadline-less work never preempts; no estimate yet
    occupied = [s for s in slots if s is not None]
    if len(occupied) < len(slots):
        return None  # a free lane exists: admit, don't evict
    wait_iters = min(s.iters_left for s in occupied)
    if deadline - now >= (iters_needed + wait_iters) * sec_per_iter:
        return None  # waiting still makes the deadline
    if deadline - now < iters_needed * sec_per_iter:
        # even an immediate slot cannot save the candidate; evicting a
        # victim would trade one miss for a possible second
        return None
    best: Optional[Tuple[int, float]] = None
    for i, s in enumerate(slots):
        if s is None or not s.preemptible:
            continue
        victim_finish = now + (iters_needed + s.iters_left) * sec_per_iter
        if s.deadline < victim_finish:
            continue  # eviction could miss the victim's deadline: unsafe
        slack = s.deadline - victim_finish
        if best is None or slack > best[1]:
            best = (i, slack)
    return best[0] if best else None


@dataclasses.dataclass(order=True)
class _Entry:
    neg_priority: int        # -priority: higher priority pops first
    eff_deadline: float
    seq: int
    payload: Any = dataclasses.field(compare=False)
    deadline: float = dataclasses.field(compare=False, default=INF)

    @property
    def priority(self) -> int:
        return -self.neg_priority


class EDFScheduler:
    """Thread-safe earliest-deadline-first queue with deterministic ties.

    Ordering is (priority desc, effective deadline asc, sequence asc).
    ``starvation_horizon`` bounds how long deadline-less work can be
    bypassed: its effective deadline is ``now + horizon`` at push time,
    after which it outranks any same-priority arrival whose real deadline
    lies further out. Re-pushing a parked entry via ``push(...,
    seq=entry.seq, eff_deadline=entry.eff_deadline,
    priority=entry.priority)`` preserves its original rank.
    """

    def __init__(self, starvation_horizon: float = 60.0):
        self.starvation_horizon = starvation_horizon
        self.cond = threading.Condition(threading.RLock())
        self._heap: List[_Entry] = []
        self._seq = 0
        self.pushed = 0   # lifetime counters (stress-test bookkeeping)
        self.popped = 0

    def __len__(self) -> int:
        with self.cond:
            return len(self._heap)

    def push(self, payload: Any, deadline: Optional[float], now: float,
             seq: Optional[int] = None,
             eff_deadline: Optional[float] = None,
             priority: int = 0) -> _Entry:
        """Enqueue; returns the entry (its seq identifies re-admissions)."""
        with self.cond:
            if seq is None:
                seq = self._seq
                self._seq += 1
                self.pushed += 1
            if eff_deadline is None:
                eff_deadline = (deadline if deadline is not None
                                else now + self.starvation_horizon)
            e = _Entry(neg_priority=-priority, eff_deadline=eff_deadline,
                       seq=seq, payload=payload,
                       deadline=INF if deadline is None else deadline)
            heapq.heappush(self._heap, e)
            self.cond.notify_all()
            return e

    def peek(self) -> Optional[_Entry]:
        with self.cond:
            return self._heap[0] if self._heap else None

    def pop(self) -> Optional[_Entry]:
        with self.cond:
            if not self._heap:
                return None
            self.popped += 1
            e = heapq.heappop(self._heap)
            self.cond.notify_all()   # wake BLOCK-policy offer() waiters
            return e


class BoundedEDFScheduler(EDFScheduler):
    """EDF queue with a capacity bound and an overload policy — the
    gateway's admission buffer. ``offer()`` is the policy-aware front
    door; the inherited ``push`` stays unbounded for internal re-pushes.

    ``capacity=None`` means unbounded (the baseline the SHED policy is
    benchmarked against). ``close()`` permanently wakes and fails
    BLOCK-policy waiters so a gateway shutdown cannot strand submitters.
    """

    def __init__(self, capacity: Optional[int] = None,
                 policy: Union[OverloadPolicy, str] = OverloadPolicy.BLOCK,
                 starvation_horizon: float = 60.0):
        super().__init__(starvation_horizon)
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.capacity = capacity
        self.policy = OverloadPolicy.coerce(policy)
        self.shed_count = 0       # lifetime SHED evictions
        self.rejected = 0         # lifetime REJECT failures
        self._closed = False
        # overload telemetry: the counters mirror shed_count/rejected
        # into the process metrics registry; the depth gauge samples the
        # heap at READ time (callback), so offers/pops record nothing
        reg = obs_metrics.default_registry()
        self._m_shed = reg.counter(
            "topo_sheds_total",
            "requests evicted by the SHED_LATEST_DEADLINE policy")
        self._m_reject = reg.counter(
            "topo_rejects_total",
            "submits failed by the REJECT policy (QueueFull)")
        reg.gauge("topo_queue_depth",
                  "bounded admission-queue depth (gateway front door)",
                  callback=lambda: len(self._heap))

    def close(self):
        with self.cond:
            self._closed = True
            self.cond.notify_all()

    def _worst(self) -> Optional[_Entry]:
        """The lowest-ranked queued entry (last to pop): max
        (neg_priority, eff_deadline, seq) — i.e. the latest effective
        deadline within the lowest priority class."""
        with self.cond:
            return max(self._heap) if self._heap else None

    def offer(self, payload: Any, deadline: Optional[float], now: float,
              priority: int = 0,
              timeout: Optional[float] = None
              ) -> Tuple[Optional[_Entry], Optional[_Entry]]:
        """Policy-aware enqueue. Returns ``(entry, shed)``:

          * ``(entry, None)`` — admitted (possibly after BLOCKing).
          * ``(entry, shed)`` — admitted by evicting ``shed`` (SHED
            policy); the caller owns failing ``shed.payload``'s future.
          * ``(None, entry)`` — the incoming request itself was shed
            (it ranked below everything already queued).

        REJECT raises ``QueueFull``; BLOCK raises ``QueueFull`` only if
        ``timeout`` expires, and ``RuntimeError`` if closed while
        waiting.
        """
        with self.cond:
            if self._closed:
                raise RuntimeError("admission queue is closed")
            if self.capacity is None or len(self._heap) < self.capacity:
                return self.push(payload, deadline, now,
                                 priority=priority), None
            if self.policy is OverloadPolicy.REJECT:
                self.rejected += 1
                self._m_reject.inc()
                raise QueueFull(
                    f"admission queue full ({self.capacity} pending)")
            if self.policy is OverloadPolicy.SHED_LATEST_DEADLINE:
                worst = self._worst()
                eff = (deadline if deadline is not None
                       else now + self.starvation_horizon)
                cand = (-priority, eff)
                if (worst is None
                        or cand >= (worst.neg_priority, worst.eff_deadline)):
                    # the incoming request is the least urgent: shed it
                    # without ever queueing it (seq order breaks the tie
                    # toward keeping what already waited)
                    self.shed_count += 1
                    self._m_shed.inc()
                    e = _Entry(neg_priority=-priority, eff_deadline=eff,
                               seq=-1, payload=payload,
                               deadline=INF if deadline is None
                               else deadline)
                    return None, e
                self._heap.remove(worst)
                heapq.heapify(self._heap)
                self.shed_count += 1
                self._m_shed.inc()
                return self.push(payload, deadline, now,
                                 priority=priority), worst
            # BLOCK: wait for a pop (or close/timeout) to make room
            ok = self.cond.wait_for(
                lambda: self._closed or len(self._heap) < self.capacity,
                timeout)
            if self._closed:
                raise RuntimeError("admission queue closed while blocked")
            if not ok:
                raise QueueFull(
                    f"admission queue still full ({self.capacity} "
                    f"pending) after {timeout}s")
            return self.push(payload, deadline, now,
                             priority=priority), None

    def pop_ready(self, ready: Callable[[Any], bool],
                  key: Optional[Callable[[Any], Any]] = None
                  ) -> Optional[_Entry]:
        """Pop the highest-ranked entry whose payload satisfies
        ``ready`` (e.g. "its mesh engine has queue room"), skipping
        blocked ones so one saturated mesh cannot head-of-line block the
        rest. Skipped entries are popped into a side list and re-pushed:
        O(k log n) for k not-ready entries ahead of the hit — no full
        sort or re-heapify, which matters for the unbounded
        (capacity=None) configuration under a deep backlog.

        ``key`` declares that readiness is a property of a GROUP of
        payloads (the gateway's mesh bucket), not of each payload: once
        one entry of a group tests not-ready, every later entry of the
        same group is skipped without re-evaluating ``ready``. Under a
        deep single-bucket backlog this turns k predicate calls into
        one — which matters now that the predicate sums the in-flight
        depth of a canary PAIR of engines instead of reading one
        counter. Entries whose group tested ready are still evaluated
        individually (readiness may be consumed by the pop itself)."""
        with self.cond:
            skipped: List[_Entry] = []
            found = None
            blocked_keys = set()
            while self._heap:
                e = heapq.heappop(self._heap)
                k = key(e.payload) if key is not None else None
                if k is not None and k in blocked_keys:
                    skipped.append(e)
                    continue
                if ready(e.payload):
                    found = e
                    break
                if k is not None:
                    blocked_keys.add(k)
                skipped.append(e)
            for e in skipped:
                heapq.heappush(self._heap, e)
            if found is not None:
                self.popped += 1
                self.cond.notify_all()
            return found


# ------------------------------------------------------------- elasticity


def target_slots(rate: float, base_rate: float, min_slots: int = 2,
                 max_slots: int = 8) -> int:
    """Slot width for an observed per-bucket arrival rate — the pure
    policy half of the gateway's pool elasticity. A ladder-less engine
    applies it when a bucket is built or lazily rebuilt after a cold
    eviction (its compiled step is shaped by one width, so resizing
    happens at the rebuild boundary); a ladder engine consumes it live
    as an admission cap snapped to a precompiled rung
    (``TopoServingEngine.set_target_slots``).

    ``base_rate`` is the arrival rate (requests/s) one ``min_slots``-wide
    engine is provisioned for; the width grows proportionally with the
    observed rate and is clamped to ``[min_slots, max_slots]``. Widths
    are rounded up to even so the engine can always split into shards of
    the minimum bitwise-invariant width (2). A cold bucket (rate 0, or
    no estimate yet) gets ``min_slots``."""
    if min_slots < 2:
        raise ValueError(f"min_slots must be >= 2, got {min_slots}")
    if max_slots < min_slots:
        raise ValueError(f"max_slots {max_slots} < min_slots {min_slots}")
    if rate <= 0.0 or base_rate <= 0.0:
        return min_slots
    width = min_slots * math.ceil(rate / base_rate)
    width += width % 2
    return max(min_slots, min(max_slots, width))


DEFAULT_LADDER = (2, 4, 8, 16)


def ladder_rungs(max_width: int,
                 ladder: Optional[Sequence[int]] = None,
                 min_width: int = 2) -> Tuple[int, ...]:
    """The sorted tuple of batch widths an engine shard precompiles.

    ``ladder`` defaults to ``DEFAULT_LADDER`` (2/4/8/16) and is clamped
    to ``[min_width, max_width]``; ``max_width`` (the shard's full
    width) is always included so full occupancy stays dispatchable.
    Widths below 2 are rejected — a unit batch dim lowers differently
    in the reference and 2 is the port's minimum width too.
    """
    if min_width < 2:
        raise ValueError(f"min_width must be >= 2, got {min_width}")
    if max_width < min_width:
        raise ValueError(f"max_width {max_width} < min_width {min_width}")
    if ladder is None:
        ladder = DEFAULT_LADDER
    rungs = {int(r) for r in ladder if min_width <= int(r) <= max_width}
    rungs.add(max_width)
    return tuple(sorted(rungs))


def rung_for(occupancy: int, rungs: Sequence[int]) -> int:
    """Smallest precompiled width >= live occupancy — the per-tick
    dispatch width. Occupancy above the top rung clamps to it (the
    admission loop never admits past the shard width, so that branch
    only matters for out-of-range caps fed by ``set_target_slots``)."""
    for r in rungs:
        if r >= occupancy:
            return r
    return rungs[-1]


def shape_class_for(mesh: Tuple[int, int],
                    classes: Sequence[Tuple[int, int]]
                    ) -> Optional[Tuple[int, int]]:
    """The canonical shape class serving ``mesh``: the smallest-area
    class with ``NELX >= nelx and NELY >= nely`` (ties break to the
    lexicographically smallest class — deterministic routing). None
    when no class contains the mesh; the gateway then serves the exact
    mesh in its own bucket, as without shape classes."""
    fits = [c for c in classes
            if c[0] >= mesh[0] and c[1] >= mesh[1]]
    if not fits:
        return None
    return min(fits, key=lambda c: (c[0] * c[1], c))
