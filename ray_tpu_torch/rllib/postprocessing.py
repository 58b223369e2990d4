"""The port's copy of ray_tpu/rllib/postprocessing.py: numpy on the host,
bit for bit the reference's arithmetic.

GAE advantage estimation over vectorized rollout lanes.

Parity: rllib/evaluation/postprocessing.py (`compute_advantages`) — generalized
advantage estimation (Schulman et al. 2015). Vectorized over all env lanes at
once: one reverse scan over the time axis instead of per-episode Python loops.
"""

from __future__ import annotations

import numpy as np


def compute_gae_lanes(
    rewards: np.ndarray,      # [T, N]
    values: np.ndarray,       # [T, N] critic predictions
    bootstrap_value: np.ndarray,  # [N] V(s_T) for the step after the fragment
    terminateds: np.ndarray,  # [T, N] episode ended inside the env (V(next)=0)
    truncateds: np.ndarray,   # [T, N] time-limit cut (bootstrap with V(next))
    gamma: float = 0.99,
    lambda_: float = 0.95,
):
    """Returns (advantages [T, N], value_targets [T, N]).

    At a terminated step the next value is 0; at a truncated step we would need
    V(terminal obs) — the vector env auto-resets and does not surface it, so we
    treat truncation like termination for the advantage at that step. With
    fragment lengths >= a few hundred steps the bias is negligible for
    CartPole-scale tasks (the reference makes the same simplification for its
    vectorized fast path).
    """
    T, N = rewards.shape
    next_values = np.concatenate([values[1:], bootstrap_value[None]], axis=0)
    done = terminateds | truncateds
    not_done = 1.0 - done.astype(np.float32)
    deltas = rewards + gamma * next_values * not_done - values
    advantages = np.zeros((T, N), np.float32)
    gae = np.zeros(N, np.float32)
    for t in range(T - 1, -1, -1):
        gae = deltas[t] + gamma * lambda_ * not_done[t] * gae
        advantages[t] = gae
    value_targets = advantages + values
    return advantages, value_targets
