"""Population plane: deterministic client unreliability, round deadlines
with over-selection, and the per-client circuit breaker. The port's own
copy of `repro/federated/population.py` (numpy only; the reference's
package pulls in jax on import).

The paper's deployment setting is a fleet of unreliable mobile devices.
This module is the host-side model of that unreliability and of the
server's countermeasures:

  * `UnreliabilityConfig`: a stateless seeded per-(client, round)
    latency and failure model. Every draw is a pure function of
    ``(seed, client, round)``, so arrivals do not depend on worker
    scheduling, prefetch depth or the resume point: nothing to
    checkpoint, nothing to race on. It is apart from the failure
    plane's `FaultConfig`, which corrupts the gradients of clients that
    did arrive; this plane decides who arrives at all.
  * `plan_round`: the deadline and over-selection arithmetic: which of a
    round's ``m·(1+over_select)`` candidates fail, which miss the
    deadline, and the first ``m`` arrivals in latency order.
  * `CircuitBreaker`: quarantines clients that fail repeatedly:
    ``threshold`` consecutive failures open the breaker for ``cooldown``
    rounds (the client is left out of selection), after which it
    half-opens for one trial pick; a success closes it, a failure opens
    it again at once.

The trainer composes these with the worker pool and aggregates the
arrived rows through the renormalizing `masked_mean` (K2 over the
zero-weight pad rows, then one division).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _draw_rng(*entropy) -> np.random.RandomState:
    return np.random.RandomState(
        np.random.MT19937(np.random.SeedSequence(entropy)))


@dataclasses.dataclass(frozen=True)
class UnreliabilityConfig:
    """Seeded per-client latency and failure model (stateless draws).

    ``fail_rate`` is the per-(client, round) transient failure
    probability; ``chronic_frac`` the fraction of the population that
    always fails (the dead-device tail the breaker exists for). Latency
    is lognormal per client (median ``latency_mean``, spread
    ``latency_sigma`` across clients) times a per-round lognormal jitter
    (``jitter_sigma``). Units are arbitrary but shared with the trainer's
    ``round_deadline``.

    >>> u = UnreliabilityConfig(fail_rate=0.5, seed=1)
    >>> u.draw(3, 7) == u.draw(3, 7)   # pure function of (client, round)
    True
    """
    fail_rate: float = 0.1
    chronic_frac: float = 0.0
    latency_mean: float = 1.0
    latency_sigma: float = 0.5
    jitter_sigma: float = 0.25
    seed: int = 0

    def __post_init__(self):
        for f in ("fail_rate", "chronic_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")

    def client_profile(self, client: int):
        """(chronic, base_latency): the fixed per-client draws."""
        rng = _draw_rng(self.seed, int(client))
        chronic = rng.random_sample() < self.chronic_frac
        base = float(np.exp(rng.normal(np.log(self.latency_mean),
                                       self.latency_sigma)))
        return chronic, base

    def draw(self, client: int, round_: int):
        """(failed, latency) for one (client, round) pair."""
        chronic, base = self.client_profile(client)
        rng = _draw_rng(self.seed, int(client), int(round_))
        failed = chronic or rng.random_sample() < self.fail_rate
        latency = base * float(np.exp(rng.normal(0.0, self.jitter_sigma)))
        return bool(failed), latency


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One round's arrival outcome (int64 arrays of client ids).
    ``arrived`` is in arrival order (latency, then candidate position),
    at most ``m`` long; ``failed`` never responded; ``late`` responded
    after the deadline; ``surplus`` beat the deadline but lost the
    first-m race (their upload is discarded)."""
    candidates: np.ndarray
    arrived: np.ndarray
    failed: np.ndarray
    late: np.ndarray
    surplus: np.ndarray
    latencies: np.ndarray    # per candidate, NaN where failed


def plan_round(candidates, round_: int,
               unreliability: Optional[UnreliabilityConfig],
               deadline: Optional[float], m: int) -> RoundPlan:
    """Deadline and over-selection arithmetic for one round.

    With no unreliability model every candidate arrives at latency 0 in
    candidate order: the first ``m`` are taken, the rest are surplus.
    The outcome depends only on the candidate ids, the round index and
    the config (the worker pool does the work; this plan decides the
    outcome).
    """
    cand = np.asarray(candidates, np.int64)
    n = len(cand)
    if unreliability is None:
        failed = np.zeros(n, bool)
        lat = np.zeros(n, np.float64)
    else:
        drawn = [unreliability.draw(int(c), int(round_)) for c in cand]
        failed = np.array([d[0] for d in drawn], bool)
        lat = np.array([d[1] for d in drawn], np.float64)
    on_time = ~failed if deadline is None else (~failed) & (lat <= deadline)
    # arrival order: latency, candidate position as the tie-breaker
    order = np.lexsort((np.arange(n), np.where(on_time, lat, np.inf)))
    ok = order[on_time[order]]
    arrived = cand[ok[:m]]
    surplus = cand[np.sort(ok[m:])]
    late = cand[(~failed) & ~on_time]
    return RoundPlan(candidates=cand, arrived=arrived,
                     failed=cand[failed], late=late, surplus=surplus,
                     latencies=np.where(failed, np.nan, lat))


@dataclasses.dataclass
class CircuitBreaker:
    """Per-client quarantine of repeatedly failing clients.

    closed --threshold consecutive failures--> open (left out of
    selection for ``cooldown`` rounds) --cooldown elapses--> half-open
    (selectable; one trial) --success--> closed / --failure--> open
    again at once.

    >>> b = CircuitBreaker(threshold=2, cooldown=3)
    >>> b.record_failure(5, 1); b.record_failure(5, 2)
    >>> b.state(5, 3), b.state(5, 2 + 1 + 3)
    ('open', 'half_open')
    """
    threshold: int = 3
    cooldown: int = 10

    def __post_init__(self):
        if self.threshold < 1 or self.cooldown < 1:
            raise ValueError("threshold and cooldown must be >= 1")
        self._fails: dict = {}        # client -> consecutive failures
        self._open_until: dict = {}   # client -> first half-open round

    def record_failure(self, client: int, round_: int):
        n = self._fails.get(client, 0) + 1
        if n >= self.threshold:
            # open for `cooldown` rounds after this one; the count stays
            # at threshold - 1 so the half-open trial's one failure opens
            # it again
            self._open_until[client] = round_ + 1 + self.cooldown
            self._fails[client] = self.threshold - 1
        else:
            self._fails[client] = n

    def record_success(self, client: int):
        self._fails.pop(client, None)
        self._open_until.pop(client, None)   # the half-open trial passed

    def state(self, client: int, round_: int) -> str:
        if client in self._open_until:
            return ("open" if round_ < self._open_until[client]
                    else "half_open")
        return "closed"

    def blocked(self, round_: int) -> set:
        """Clients left out of round ``round_``'s selection."""
        return {c for c, r in self._open_until.items() if round_ < r}

    def state_dict(self) -> dict:
        return {"fails": [[int(c), int(n)] for c, n in
                          sorted(self._fails.items())],
                "open": [[int(c), int(r)] for c, r in
                         sorted(self._open_until.items())]}

    def load_state(self, d: dict):
        self._fails = {int(c): int(n) for c, n in d.get("fails", [])}
        self._open_until = {int(c): int(r) for c, r in d.get("open", [])}
