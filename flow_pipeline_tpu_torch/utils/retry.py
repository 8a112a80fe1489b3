"""Bounded exponential backoff with jitter: the one retry policy of the
external edges (sink writes).

A copy of flow_pipeline_tpu/utils/retry.py (stdlib only):

- bounded: a hard attempt cap;
- exponential with jitter: delays double per attempt up to a cap, each
  multiplied by a factor drawn from [1, 1 + jitter];
- retryable means transient: the default filter is ``OSError``
  (connection errors, timeouts, injected
  :class:`~flow_pipeline_tpu_torch.utils.faults.FaultInjected` faults).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, Sequence


def backoff_delays(attempts: int, base: float, cap: float,
                   jitter: float, rng: random.Random):
    """The delay before each RETRY (attempts - 1 values): exponential
    from ``base`` doubling to ``cap``, each multiplied by a factor drawn
    uniformly from [1, 1 + jitter]."""
    for i in range(max(0, attempts - 1)):
        delay = min(cap, base * (2 ** i))
        yield delay * (1.0 + jitter * rng.random())


def retry_call(fn: Callable, *, attempts: int = 4, base: float = 0.05,
               cap: float = 2.0, jitter: float = 0.25,
               retry_on: Sequence[type] = (OSError,),
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable] = None,
               rng: Optional[random.Random] = None):
    """Call ``fn()`` with up to ``attempts`` tries. Exceptions matching
    ``retry_on`` back off and retry; the last attempt's exception
    propagates. ``on_retry(attempt_index, exc, delay)`` observes each
    retry (metrics/log hooks). ``sleep``/``rng`` are injectable so tests
    run instantly and deterministically."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    rng = rng or random.Random()
    delays = backoff_delays(attempts, base, cap, jitter, rng)
    for attempt in range(attempts):
        try:
            return fn()
        except tuple(retry_on) as e:
            if attempt == attempts - 1:
                raise
            delay = next(delays)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
