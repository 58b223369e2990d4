"""V-trace off-policy actor-critic targets (IMPALA, Espeholt et al. 2018).

Counterpart of ray_tpu/rllib/vtrace.py. The reference's reverse
`lax.scan` over the time axis is a loop over T here, each step a few
elementwise ops on the tensors' device. The targets are constants of the
loss (the reference's stop_gradient), so the whole computation runs
without autograd and returns detached tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class VTraceReturns(NamedTuple):
    vs: torch.Tensor             # [T, N] v-trace value targets
    pg_advantages: torch.Tensor  # [T, N] policy-gradient advantages


@torch.no_grad()
def vtrace_from_logps(
    behavior_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    discounts: torch.Tensor,
    clip_rho_threshold: float = 1.0,
    clip_c_threshold: float = 1.0,
    clip_pg_rho_threshold: Optional[float] = None,
) -> VTraceReturns:
    """All inputs time-major.

    behavior_logp/target_logp: [T, N] log pi_b(a|s) / log pi(a|s)
    rewards:                   [T, N]
    values:                    [T, N] learner's V(s_t)
    bootstrap_value:           [N]    learner's V(s_{T}) for the next obs
    discounts:                 [T, N] gamma * (1 - done_t)

    Returns targets with no gradient: the loss takes them as constants.
    """
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho_threshold)
    if clip_pg_rho_threshold is None:
        clip_pg_rho_threshold = clip_rho_threshold
    clipped_pg_rhos = torch.clamp(rhos, max=clip_pg_rho_threshold)
    cs = torch.clamp(rhos, max=clip_c_threshold)

    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)

    # vs_minus_v[t] = delta[t] + discount[t] * c[t] * vs_minus_v[t+1]
    decay = discounts * cs
    acc = torch.zeros_like(bootstrap_value)
    rev = []
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + decay[t] * acc
        rev.append(acc)
    vs = values + torch.stack(rev[::-1])

    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_advantages = clipped_pg_rhos * (rewards + discounts * vs_t_plus_1 - values)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
