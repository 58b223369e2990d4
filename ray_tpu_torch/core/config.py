"""Runtime configuration flags.

The port's copy of ray_tpu/core/config.py, cut to the fields the ported
modules read (names and defaults the reference's): every tunable lives in
this table, overridable via ``RAY_TPU_<NAME>`` environment variables,
readable as ``ray_tpu_torch._config.<name>``. The other planes' fields
come with those planes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


def _env(name: str, default):
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    t = type(default)
    if t is bool:
        return raw.lower() in ("1", "true", "yes")
    if t is int:
        return int(raw)
    if t is float:
        return float(raw)
    return raw


@dataclass
class Config:
    # exponential backoff between task retries (retry_exceptions): delay(n) =
    # min(max, base * multiplier^(n-1)) * (1 ± jitter) (util/backoff.py)
    retry_backoff_base_ms: float = 50.0
    retry_backoff_max_ms: float = 5_000.0
    retry_backoff_multiplier: float = 2.0
    retry_backoff_jitter: float = 0.5
    # train: per-round driver wait on worker polls before probing liveness
    train_poll_timeout_s: float = 120.0

    def __post_init__(self):
        for f in fields(self):
            object.__setattr__(self, f.name, _env(f.name, getattr(self, f.name)))


_config = Config()
