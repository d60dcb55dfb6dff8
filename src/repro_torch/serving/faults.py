"""Deterministic fault injection for the serving stack (DESIGN.md §4f; a
copy of ``repro.serving.faults``).

Every adaptation point in the engine — pool-bound block allocation, the
background INT4 restore worker, the ILP planner, the predictive prefetch
puller — is also a fault surface. ``FaultInjector`` makes each one
injectable so the degradation paths (preemption-by-recompute, sync
restore failover, static-plan fallback, prefetch miss accounting) are
*testable and CI-provable* instead of only reachable under real memory
pressure or a wedged host thread.

Sites (the hook map; where each ``fire`` call lives):

- ``"kv_alloc"``  — ``BlockAllocator._alloc_reserved``/``_alloc_extra``:
                    raising ``OutOfBlocks`` here forces the engine's
                    preemption-by-recompute path at an exact allocation
                    index, independent of real pool pressure.
- ``"restore"``   — ``TransitionExecutor.restore*``: failing forces the
                    engine's sync-relayout failover; delaying past the
                    engine's ``restore_timeout_s`` forces the watchdog
                    timeout at the restore barrier.
- ``"ilp"``       — ``HAPSession.plan_for`` (before the source solve):
                    failing forces the static-plan degradation fallback.
- ``"prefetch"``  — ``InferenceEngine._prefetch_pull``, once per (row,
                    leaf) in row-major order before the pull's batched
                    upload: failing forces the background pull's error
                    path for that row (it stays unstaged; the barrier
                    restores it synchronously).

Schedules are **deterministic**: ``at=`` fires on exactly one 0-based
call index, ``times=`` on the first N calls, ``p=`` per call from a
seeded RNG (same seed, same firing pattern — every stress run is
replayable). Rules stack per site; delays and failures compose (a delay
rule sleeps, then a fail rule may still raise).

Injection is *opt-in per engine*: ``InferenceEngine(faults=...)`` threads
one injector through the allocator, the transition executor and the
session; code paths without an injector pay a single ``None`` check.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Dict, List, Optional

from .kv_cache import OutOfBlocks

SITES = ("kv_alloc", "restore", "ilp", "prefetch")


class FaultError(RuntimeError):
    """The generic injected failure (sites without a domain exception)."""


@dataclasses.dataclass
class _Rule:
    kind: str  # "fail" | "delay"
    at: Optional[int] = None  # fire on exactly this 0-based call index
    times: Optional[int] = None  # fire on the first N calls
    p: Optional[float] = None  # fire per call with this probability
    delay_s: float = 0.0
    make_exc: Optional[Callable[[], BaseException]] = None
    fired: int = 0

    def matches(self, idx: int, rng: random.Random) -> bool:
        if self.at is not None:
            return idx == self.at
        if self.times is not None:
            return self.fired < self.times
        if self.p is not None:
            return rng.random() < self.p
        return True  # unconditional


def _default_exc(site: str) -> BaseException:
    if site == "kv_alloc":
        return OutOfBlocks(f"injected fault at site {site!r}")
    return FaultError(f"injected fault at site {site!r}")


class FaultInjector:
    """Seeded, schedulable fault source threaded through the engine.

    ``fail(site, ...)`` registers a raising rule, ``delay(site, ...)`` a
    sleeping one; instrumented code calls ``fire(site)`` once per
    operation. ``calls``/``fired`` expose per-site counts so tests can
    assert exactly how many injections landed.
    """

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._rules: Dict[str, List[_Rule]] = {}
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    def _check_site(self, site: str) -> None:
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r} (valid: {SITES})")

    def fail(
        self,
        site: str,
        *,
        at: Optional[int] = None,
        times: Optional[int] = None,
        p: Optional[float] = None,
        exc: Optional[Callable[[], BaseException]] = None,
    ) -> "FaultInjector":
        """Register a failure rule for ``site`` (chainable).

        Exactly one of ``at``/``times``/``p`` selects the schedule (none
        = every call). ``exc`` is a zero-arg exception factory; the
        default raises ``OutOfBlocks`` for ``kv_alloc`` and
        ``FaultError`` elsewhere.
        """
        self._check_site(site)
        if sum(x is not None for x in (at, times, p)) > 1:
            raise ValueError("pick at most one of at/times/p")
        self._rules.setdefault(site, []).append(
            _Rule(kind="fail", at=at, times=times, p=p, make_exc=exc)
        )
        return self

    def delay(
        self,
        site: str,
        delay_s: float,
        *,
        at: Optional[int] = None,
        times: Optional[int] = None,
        p: Optional[float] = None,
    ) -> "FaultInjector":
        """Register a sleeping rule for ``site`` (chainable) — e.g. stall
        the background restore past the engine's watchdog timeout."""
        self._check_site(site)
        if sum(x is not None for x in (at, times, p)) > 1:
            raise ValueError("pick at most one of at/times/p")
        self._rules.setdefault(site, []).append(
            _Rule(kind="delay", at=at, times=times, p=p, delay_s=float(delay_s))
        )
        return self

    def fire(self, site: str) -> None:
        """One instrumented operation at ``site``: sleep through matching
        delay rules, then raise on the first matching fail rule."""
        self._check_site(site)
        idx = self.calls.get(site, 0)
        self.calls[site] = idx + 1
        raise_rule: Optional[_Rule] = None
        for rule in self._rules.get(site, ()):
            if not rule.matches(idx, self._rng):
                continue
            rule.fired += 1
            self.fired[site] = self.fired.get(site, 0) + 1
            if rule.kind == "delay":
                time.sleep(rule.delay_s)
            elif raise_rule is None:
                raise_rule = rule
        if raise_rule is not None:
            exc = (
                raise_rule.make_exc() if raise_rule.make_exc is not None
                else _default_exc(site)
            )
            raise exc

    def fired_at(self, site: str) -> int:
        return self.fired.get(site, 0)
