"""Task/actor option validation and defaults.

The port's copy of ray_tpu/core/options.py with GPUs in the TPUs' place:
`num_gpus` asks for "GPU" chips, and `num_tpus` is refused with a message
that names `num_gpus`, as the reference refuses `num_gpus`.
Parity: python/ray/_private/ray_option_utils.py:211 centralizes option plumbing in
the reference. Same role here; a single dataclass feeds both the `@remote` decorator
and the per-call ``.options(...)`` override path.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Union


def _validate_num_returns(n) -> None:
    """int >= 0, or the literal "streaming" (generator tasks/methods push
    each yielded item as its own object; parity: ray's
    num_returns="streaming" → ObjectRefGenerator)."""
    if n == "streaming":
        return
    if isinstance(n, bool) or not isinstance(n, int) or n < 0:
        raise ValueError(
            f'num_returns must be an int >= 0 or "streaming", got {n!r}'
        )


@dataclass
class RemoteOptions:
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    memory: Optional[float] = None
    resources: Dict[str, float] = field(default_factory=dict)
    num_returns: Union[int, str] = 1
    # streaming only: bound on the producer's lead over the consumer (the
    # worker blocks in `yield` once this many items are in flight); None =
    # pipeline freely up to the streaming plane's cap
    generator_backpressure_num_objects: Optional[int] = None
    max_retries: Optional[int] = None          # tasks
    retry_exceptions: bool = False
    max_restarts: int = 0                      # actors
    max_task_retries: int = 0                  # actor tasks
    max_concurrency: int = 1                   # actor concurrency
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
    name: Optional[str] = None                 # named actors
    namespace: Optional[str] = None
    get_if_exists: bool = False
    lifetime: Optional[str] = None             # None | "detached"
    scheduling_strategy: Any = None            # str | NodeAffinity… | PlacementGroup…
    placement_group: Any = None
    placement_group_bundle_index: int = -1
    runtime_env: Optional[Dict[str, Any]] = None
    accelerator_type: Optional[str] = None     # e.g. "GPU-nvidia-h100-80gb-hbm3"
    _metadata: Dict[str, Any] = field(default_factory=dict)

    def merged_with(self, **overrides) -> "RemoteOptions":
        _validate_option_keys(overrides)
        clean = {k: v for k, v in overrides.items() if v is not None or k in ("name",)}
        out = replace(self, **clean)
        _validate_num_returns(out.num_returns)
        if out.generator_backpressure_num_objects is not None and (
            out.generator_backpressure_num_objects < 1
        ):
            raise ValueError("generator_backpressure_num_objects must be >= 1")
        return out

    def task_resources(self, is_actor: bool = False) -> Dict[str, float]:
        res = dict(self.resources)
        if self.num_cpus is not None:
            res["CPU"] = float(self.num_cpus)
        else:
            # Tasks default to 1 CPU; actor *methods* are cheap (the actor holds
            # its resources for its lifetime), matching reference defaults.
            res["CPU"] = 0.0 if is_actor else 1.0
        if self.num_gpus:
            res["GPU"] = float(self.num_gpus)
        if self.memory:
            res["memory"] = float(self.memory)
        if self.accelerator_type:
            res[self.accelerator_type] = 0.001
        return {k: v for k, v in res.items() if v}


def _validate_option_keys(kwargs):
    if "num_tpus" in kwargs:
        raise ValueError(
            "ray_tpu_torch runs on NVIDIA GPUs: use num_gpus instead of num_tpus"
        )
    unknown = set(kwargs) - set(RemoteOptions.__dataclass_fields__)
    if unknown:
        raise ValueError(f"Unknown remote options: {sorted(unknown)}")


def options_from_kwargs(is_actor: bool, **kwargs) -> RemoteOptions:
    _validate_option_keys(kwargs)
    opts = RemoteOptions(**kwargs)
    _validate_num_returns(opts.num_returns)
    if opts.generator_backpressure_num_objects is not None and (
        opts.generator_backpressure_num_objects < 1
    ):
        raise ValueError("generator_backpressure_num_objects must be >= 1")
    if not is_actor and (opts.max_restarts or opts.max_task_retries):
        raise ValueError("max_restarts/max_task_retries are actor-only options")
    return opts
