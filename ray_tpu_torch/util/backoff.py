"""Retry delays: exponential backoff with jitter.

The port's copy of the delay rule of ray_tpu/util/backoff.py's
``BackoffPolicy``, which the in-process backend sleeps by between task
retries. Not ported yet: serve's ``RetryBudget``, per-call-site overrides,
and the chaos plane that seeds the jitter RNG in the reference (here it
draws from OS entropy).
"""

from __future__ import annotations

import random

from ray_tpu_torch.core.config import _config


def delay(attempt: int) -> float:
    """Seconds to sleep before retry #attempt (1-based):
    min(max, base * multiplier^(attempt-1)) * (1 ± jitter), from the
    config's ``retry_backoff_*`` fields."""
    n = max(1, int(attempt))
    d = min(_config.retry_backoff_max_ms,
            _config.retry_backoff_base_ms * _config.retry_backoff_multiplier ** (n - 1)) / 1000.0
    if _config.retry_backoff_jitter:
        d *= 1.0 + _config.retry_backoff_jitter * (2.0 * random.random() - 1.0)
    return max(0.0, d)
