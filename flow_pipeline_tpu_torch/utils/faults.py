"""Deterministic fault injection.

A copy of flow_pipeline_tpu/utils/faults.py (stdlib only), with the
reference's plan grammar, sites and per-site random streams, so the
same plan injects the same faults in both packages:

- A fault plan names sites and per-call failure probabilities::

      sink.write:p=0.05;bus.poll:p=0.02@seed=7

  parsed by :func:`parse_plan`; configured by ``-faults`` or the
  ``FLOWTPU_FAULTS`` env fallback.
- A site may carry ``delay=<seconds>`` instead: a hit there sleeps
  instead of raising (a slow dependency, not a dead one). ``delay=``
  without ``p=`` means p=1.
- Each site draws from its own ``random.Random`` seeded by
  ``(seed, site)``, so the sequence at one site is a pure function of the
  plan and the call index at that site.
- An injected fault raises :class:`FaultInjected`, an ``OSError``, so
  the retry and recovery paths treat it as a real transport failure.
- Off costs one attribute read: call sites guard with
  ``if FAULTS.active``.

:data:`KNOWN_SITES` is the reference's list; the port checks
``sink.write``, ``bus.poll`` and ``bus.produce`` (the others belong to
subsystems not ported yet). A plan naming an unknown site is refused.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Optional

from ..obs.metrics import REGISTRY

# The seams the dataplane actually threads FAULTS through. configure()
# rejects unknown sites: a chaos leg whose plan names a site nothing
# checks would "pass" by injecting nothing.
KNOWN_SITES = frozenset({
    "sink.write", "mesh.submit", "mesh.sync", "kafka.send", "kafka.poll",
    "serve.publish",
    # the in-process bus: the produce path and the fetch path every
    # consumer rides
    "bus.produce", "bus.poll", "gateway.poll",
})


class FaultInjected(OSError):
    """An injected transport/IO fault. Subclasses OSError so the normal
    retry/recovery paths handle it exactly like a real failure."""


def parse_plan_full(spec: str) -> tuple[dict[str, tuple[float, float]], int]:
    """``"site:p=0.05;site2:delay=0.02@seed=7"`` ->
    ({site: (p, delay)}, seed). Raises ValueError on malformed specs,
    unknown sites, probabilities outside [0, 1], or delays outside
    [0, 60]. ``delay=`` without ``p=`` implies p=1 (every call stalls)."""
    spec = spec.strip()
    seed = 0
    if "@" in spec:
        spec, _, tail = spec.rpartition("@")
        key, _, val = tail.partition("=")
        if key.strip() != "seed":
            raise ValueError(f"expected @seed=N, got @{tail!r}")
        seed = int(val)
    sites: dict[str, tuple[float, float]] = {}
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        site, sep, params = part.partition(":")
        site = site.strip()
        if not sep:
            raise ValueError(
                f"fault site {part!r} needs :p=<prob> and/or "
                f":delay=<seconds>")
        if site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r} (known: "
                f"{', '.join(sorted(KNOWN_SITES))})")
        p: Optional[float] = None
        delay = 0.0
        for param in filter(None, (s.strip() for s in params.split(":"))):
            key, _, val = param.partition("=")
            key = key.strip()
            if key == "p":
                p = float(val)
                if not 0.0 <= p <= 1.0:
                    raise ValueError(
                        f"fault site {site!r}: p={p} outside [0, 1]")
            elif key == "delay":
                delay = float(val)
                if not 0.0 <= delay <= 60.0:
                    raise ValueError(
                        f"fault site {site!r}: delay={delay} outside "
                        f"[0, 60] seconds")
            else:
                raise ValueError(
                    f"fault site {site!r}: expected p=<prob> or "
                    f"delay=<seconds>, got {param!r}")
        if p is None:
            if delay <= 0.0:
                raise ValueError(
                    f"fault site {site!r}: expected p=<prob>, "
                    f"got {params!r}")
            p = 1.0  # delay-only site: every call stalls
        sites[site] = (p, delay)
    return sites, seed


def parse_plan(spec: str) -> tuple[dict[str, float], int]:
    """``"site:p=0.05;site2:p=0.02@seed=7"`` -> ({site: p}, seed) —
    the original probability-only view (delay parameters are parsed
    and validated, then dropped; :func:`parse_plan_full` keeps them)."""
    sites, seed = parse_plan_full(spec)
    return {name: pd[0] for name, pd in sites.items()}, seed


class _Site:
    __slots__ = ("p", "delay", "rng", "rolls", "injected", "delayed")

    def __init__(self, p: float, seed: int, name: str, delay: float = 0.0):
        self.p = p
        self.delay = delay  # > 0: a hit stalls instead of raising
        # per-site stream: the site name folds into the seed so streams
        # are independent — call interleaving across sites cannot shift
        # another site's Bernoulli sequence
        self.rng = random.Random(f"{seed}:{name}")
        self.rolls = 0
        self.injected = 0
        self.delayed = 0


class FaultPlan:
    """The process-global fault plan. ``configure(spec)`` arms it;
    ``configure(None)`` / ``configure("")`` disarms (tests MUST disarm
    in teardown — the plan is process state like TRACER)."""

    def __init__(self):
        self.active = False
        self._lock = threading.Lock()
        self._sites: dict[str, _Site] = {}
        self.spec = ""
        self.m_injected = REGISTRY.counter(
            "faults_injected_total",
            "flowchaos injected faults (label: site)")
        self.m_delayed = REGISTRY.counter(
            "faults_delayed_total",
            "flowchaos injected latency stalls (label: site) — delay "
            "sites slow a call instead of failing it")

    def configure(self, spec: Optional[str]) -> None:
        """Arm/disarm from a plan spec. Empty/None = off."""
        with self._lock:
            if not spec:
                self._sites = {}
                self.active = False
                self.spec = ""
                return
            sites, seed = parse_plan_full(spec)
            self._sites = {name: _Site(p, seed, name, delay)
                           for name, (p, delay) in sites.items()}
            self.spec = spec
            self.active = any(s.p > 0 for s in self._sites.values())

    def _roll(self, site: str) -> tuple[bool, float]:
        """One Bernoulli roll on the site's deterministic stream ->
        (hit, delay seconds). The roll discipline is identical for
        failure and latency sites — the delay only changes what a hit
        DOES, never the stream."""
        with self._lock:
            st = self._sites.get(site)
            if st is None or st.p <= 0.0:
                # p=0 sites still exist (the bench A/B runs the armed
                # path with p=0) but consume no roll — a zero-p site
                # must not perturb its own future stream
                return False, 0.0
            st.rolls += 1
            hit = st.rng.random() < st.p
            delay = st.delay
            if hit:
                if delay > 0.0:
                    st.delayed += 1
                else:
                    st.injected += 1
        if hit:
            if delay > 0.0:
                self.m_delayed.inc(site=site)
            else:
                self.m_injected.inc(site=site)
        return hit, delay

    def should_fail(self, site: str) -> bool:
        """One Bernoulli roll on the site's deterministic stream. Call
        guarded: ``if FAULTS.active and FAULTS.should_fail(...)``.
        Latency sites never FAIL — a hit there returns False (check()
        is where the stall happens)."""
        hit, delay = self._roll(site)
        return hit and delay <= 0.0

    def check(self, site: str) -> None:
        """Raise FaultInjected when the site's roll fails; SLEEP (the
        injected latency, outside the plan lock) when the site is a
        delay site — a slow dependency, not a dead one."""
        if not self.active:
            return
        hit, delay = self._roll(site)
        if not hit:
            return
        if delay > 0.0:
            time.sleep(delay)
            return
        raise FaultInjected(f"injected fault at {site} "
                            f"(plan {self.spec!r})")

    def snapshot(self) -> dict:
        """{site: {"p", "delay", "rolls", "injected", "delayed"}} —
        the bench artifact's injection record."""
        with self._lock:
            return {name: {"p": st.p, "delay": st.delay,
                           "rolls": st.rolls, "injected": st.injected,
                           "delayed": st.delayed}
                    for name, st in self._sites.items()}


FAULTS = FaultPlan()
