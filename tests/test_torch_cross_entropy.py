"""Port vs JAX: masked softmax cross-entropy (ray_tpu_torch.ops.cross_entropy).

The same numpy logits and targets (some -1) go through ray_tpu's
`softmax_xent` (custom VJP) and the port's, forward and backward. Both
compute in f32 from the given logits: f32 logits at atol = rtol = 1e-5
(summation order of the exp-sum over the vocabulary); bf16 logits give the
same f32 loss (atol 1e-5) and bf16 gradients within one bf16 step of
their size (atol 2**-8 · max|grad|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.cross_entropy import softmax_xent as jxent
from ray_tpu_torch.ops.cross_entropy import softmax_xent as txent

TOL = dict(atol=1e-5, rtol=1e-5)


def make(seed, B=3, S=16, V=200):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    targets[:, -1] = -1
    targets[0, 3] = -1
    g = rng.standard_normal((B, S)).astype(np.float32)
    return logits, targets, g


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_softmax_xent_forward_and_backward_match_jax(dtype_name):
    logits, targets, g = make(0)
    jl = jnp.asarray(logits, getattr(jnp, dtype_name))
    jnll, vjp = jax.vjp(lambda x: jxent(x, jnp.asarray(targets)), jl)
    (jgrad,) = vjp(jnp.asarray(g))

    tl = torch.from_numpy(logits).to(getattr(torch, dtype_name)).requires_grad_()
    tnll = txent(tl, torch.from_numpy(targets))
    tnll.backward(torch.from_numpy(g))

    assert tnll.dtype == torch.float32
    np.testing.assert_allclose(tnll.detach().numpy(), np.asarray(jnll), **TOL)
    assert tl.grad.dtype == tl.dtype
    jg = np.asarray(jgrad.astype(jnp.float32))
    tg = tl.grad.float().numpy()
    if dtype_name == "float32":
        np.testing.assert_allclose(tg, jg, **TOL)
    else:
        np.testing.assert_allclose(tg, jg, atol=2 ** -8 * np.abs(jg).max(), rtol=0)


def test_ignored_targets_give_zero_loss_and_zero_grad():
    logits, targets, _ = make(1)
    tl = torch.from_numpy(logits).requires_grad_()
    nll = txent(tl, torch.from_numpy(targets))
    nll.sum().backward()
    ignored = torch.from_numpy(targets < 0)
    assert torch.all(nll[ignored] == 0)
    assert torch.all(tl.grad[ignored] == 0)
    # each kept row's gradient is softmax − onehot: it sums to 0
    torch.testing.assert_close(tl.grad[~ignored].sum(-1),
                               torch.zeros(int((~ignored).sum())),
                               atol=1e-6, rtol=0)


def test_saves_only_logits_lse_and_targets():
    logits, targets, _ = make(2)
    tl = torch.from_numpy(logits).bfloat16().requires_grad_()
    nll = txent(tl, torch.from_numpy(targets))
    saved = nll.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(3, 16, 200), (3, 16), (3, 16)]
    assert [t.dtype for t in saved] == [torch.bfloat16, torch.float32, torch.int64]
