"""The port's copy of ray_tpu/rllib/env/pong.py (numpy on the host, the
same dynamics and draws), registered as Pong-v0 and pong.

Dependency-free vectorized Pong (state-vector observations).

The graded BASELINE config 4 is "IMPALA Atari Pong, async CPU rollout actors
→ accelerator learner" measured in env-steps/sec. The ALE and its ROMs are not
shippable dependencies, so the framework carries a faithful two-paddle Pong
simulation: ball with velocity and paddle-deflection physics, a tracking
opponent with bounded speed, ±1 rewards per point, first-to-21 episodes.
Observations are a normalized 8-dim state vector (ball x/y/vx/vy, both paddle
y, score diff, time) rather than 210×160 pixels — the async systems topology
(many CPU actor lanes feeding one learner, v-trace correcting staleness) is
identical, which is what the benchmark measures. A real-ALE adapter can be
registered through vector_env.register_env when the ALE is available.

All N lanes step as single numpy ops (no per-lane Python loop).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.env.vector_env import VectorEnv, register_env

# court: x in [0, 1] (left->right), y in [0, 1]
PADDLE_H = 0.16          # paddle half-height 0.08
PADDLE_SPEED = 0.04      # per step
OPP_SPEED = 0.02         # opponent tracking speed (beatable)
BALL_SPEED = 0.025
MAX_VY = 0.04
WIN_SCORE = 21

NOOP, UP, DOWN = 0, 1, 2


class PongVectorEnv(VectorEnv):
    """Agent is the RIGHT paddle; opponent (scripted) the left."""

    def __init__(self, num_envs: int, max_episode_steps: int = 10_000):
        self.num_envs = num_envs
        self.obs_dim = 8
        self.num_actions = 3
        self.max_episode_steps = max_episode_steps
        n = num_envs
        self._rng = np.random.default_rng(0)
        self._bx = np.zeros(n); self._by = np.zeros(n)
        self._bvx = np.zeros(n); self._bvy = np.zeros(n)
        self._py = np.zeros(n)      # agent paddle center y
        self._oy = np.zeros(n)      # opponent paddle center y
        self._score = np.zeros(n, np.int64)   # agent - opponent
        self._pts = np.zeros(n, np.int64)     # points played
        self._steps = np.zeros(n, np.int64)

    # ------------------------------------------------------------------ util
    def _serve(self, lanes: np.ndarray, toward_agent: Optional[bool] = None):
        k = int(lanes.sum()) if lanes.dtype == bool else len(lanes)
        if k == 0:
            return
        self._bx[lanes] = 0.5
        self._by[lanes] = self._rng.uniform(0.2, 0.8, k)
        direction = (
            self._rng.choice([-1.0, 1.0], k)
            if toward_agent is None
            else np.full(k, 1.0 if toward_agent else -1.0)
        )
        self._bvx[lanes] = BALL_SPEED * direction
        self._bvy[lanes] = self._rng.uniform(-MAX_VY / 2, MAX_VY / 2, k)

    def _reset_lanes(self, lanes: np.ndarray):
        self._py[lanes] = 0.5
        self._oy[lanes] = 0.5
        self._score[lanes] = 0
        self._pts[lanes] = 0
        self._steps[lanes] = 0
        self._serve(lanes)

    def _obs(self) -> np.ndarray:
        return np.stack(
            [
                self._bx,
                self._by,
                self._bvx / BALL_SPEED,
                self._bvy / MAX_VY,
                self._py,
                self._oy,
                self._score / WIN_SCORE,
                self._steps / self.max_episode_steps,
            ],
            axis=1,
        ).astype(np.float32)

    # ------------------------------------------------------------------- api
    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._reset_lanes(np.ones(self.num_envs, bool))
        return self._obs()

    def step(self, actions: np.ndarray):
        n = self.num_envs
        act = np.asarray(actions)
        # agent paddle
        self._py += PADDLE_SPEED * (
            (act == UP).astype(np.float64) - (act == DOWN)
        )
        np.clip(self._py, PADDLE_H / 2, 1 - PADDLE_H / 2, out=self._py)
        # opponent tracks the ball with bounded speed
        delta = np.clip(self._by - self._oy, -OPP_SPEED, OPP_SPEED)
        self._oy += delta
        np.clip(self._oy, PADDLE_H / 2, 1 - PADDLE_H / 2, out=self._oy)
        # ball
        self._bx += self._bvx
        self._by += self._bvy
        # wall bounce
        low, high = self._by < 0.0, self._by > 1.0
        self._by[low] = -self._by[low]
        self._by[high] = 2.0 - self._by[high]
        self._bvy[low | high] *= -1.0
        # paddle bounce (agent at x=1, opponent at x=0); deflection adds
        # spin proportional to hit offset, so play is controllable
        hit_a = (self._bx >= 1.0) & (np.abs(self._by - self._py) <= PADDLE_H)
        hit_o = (self._bx <= 0.0) & (np.abs(self._by - self._oy) <= PADDLE_H)
        self._bx[hit_a] = 2.0 - self._bx[hit_a]
        self._bx[hit_o] = -self._bx[hit_o]
        self._bvx[hit_a | hit_o] *= -1.0
        self._bvy[hit_a] += (
            (self._by[hit_a] - self._py[hit_a]) / PADDLE_H * MAX_VY * 0.8
        )
        self._bvy[hit_o] += (
            (self._by[hit_o] - self._oy[hit_o]) / PADDLE_H * MAX_VY * 0.8
        )
        np.clip(self._bvy, -MAX_VY, MAX_VY, out=self._bvy)
        # scoring
        agent_point = (self._bx <= 0.0) & ~hit_o
        opp_point = (self._bx >= 1.0) & ~hit_a
        rewards = agent_point.astype(np.float32) - opp_point.astype(np.float32)
        scored = agent_point | opp_point
        self._score += agent_point.astype(np.int64)
        self._score -= opp_point.astype(np.int64)
        self._pts += scored.astype(np.int64)
        if scored.any():
            # winner serves toward the loser (Atari convention: loser receives)
            self._serve(agent_point, toward_agent=False)
            self._serve(opp_point, toward_agent=True)

        self._steps += 1
        terminated = self._pts >= WIN_SCORE
        truncated = (self._steps >= self.max_episode_steps) & ~terminated
        done = terminated | truncated
        if done.any():
            self._reset_lanes(done)
        return self._obs(), rewards, terminated, truncated


register_env("Pong-v0", lambda n: PongVectorEnv(n))
register_env("pong", lambda n: PongVectorEnv(n))
