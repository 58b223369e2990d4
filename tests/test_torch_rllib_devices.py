"""The RL learner's state across device types (ray_tpu_torch.rllib.learner):
a state saved by a learner on the card restores into one on the CPU and
the other way round, with the same weights, Adam moments and count, and
the same place in the permutations; the next update then runs.

Marked `cuda`: skips without a card. No JAX here, so on the GPU machine:
`python3 -m pytest --noconftest -q -m cuda tests/test_torch_rllib_devices.py`.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.env_runner import EnvRunner
from ray_tpu_torch.rllib.learner import IMPALALearner, PPOLearner
from ray_tpu_torch.rllib.models import tree_leaves


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the learner is saved on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ppo", "impala"])
@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")])
def test_state_restores_across_device_types(cuda_device, algo, src, dst):
    cls, kw, post, steps = {
        "ppo": (PPOLearner, dict(num_epochs=2, minibatch_size=64), "gae", 64),
        "impala": (IMPALALearner, {}, "vtrace", 32),
    }[algo]
    batch, _ = EnvRunner("CartPole-v1", num_envs=4, seed=0,
                         postprocess=post).sample(steps)
    saved = cls(obs_dim=4, num_actions=2, seed=0, device=src, **kw)
    saved.update(batch)
    state = saved.get_state()
    restored = cls(obs_dim=4, num_actions=2, seed=3, device=dst, **kw)
    restored.set_state(state)
    for x, y in zip(tree_leaves(state), tree_leaves(restored.get_state())):
        assert np.array_equal(x, y)
    assert {t.device.type for t in tree_leaves(restored.params)} == {dst}
    metrics = restored.update(batch)
    assert np.isfinite(metrics["total_loss"])
    assert restored._optimizer.count == 2 * saved._optimizer.count
    assert restored._perm_draws == 2 * saved._perm_draws
