"""Port vs JAX: flash-attention forward (ray_tpu_torch.ops.attention).

The same numpy inputs go through ray_tpu's Pallas kernels (interpret mode on
the CPU, as tests/test_flash_attention.py runs them) and through the port's
plain version, in f32 at the JAX tests' tolerance (atol = rtol = 2e-5). The
kernel itself runs only on the card: tests/test_torch_flash_kernel.py.
"""

import ast
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-5, rtol=2e-5)
REPO = pathlib.Path(__file__).resolve().parents[1]


def make_qkv(seed, B=2, S=256, H=4, hd=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)]


def both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [256, 160], ids=["S256", "S160"])
def test_forward_matches_jax(causal, S):
    # S=160 is not a multiple of 64: JAX halves its block, the port masks
    # the ragged tail
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(0, S=S))
    ref = jattn.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64, interpret=True)
    out = tattn.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bhsd_layout_matches_bshd():
    _, (tq, tk, tv) = both(make_qkv(1, S=128))
    o1 = tattn.flash_attention(tq, tk, tv, layout="bshd")
    o2 = tattn.flash_attention(*(x.transpose(1, 2) for x in (tq, tk, tv)),
                               layout="bhsd")
    torch.testing.assert_close(o1, o2.transpose(1, 2), **TOL)


def test_lse_and_offsets_merge_matches_jax():
    """A q chunk against two kv chunks at global offsets, merged by lse,
    equals the slice of full causal attention — and each partial (o, lse)
    matches JAX's."""
    S, half = 128, 64
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(3, B=1, S=S, H=2, hd=32))
    parts = []
    for off in (0, half):
        jo, jl = jattn.flash_attention_with_lse(
            jq[:, half:], jk[:, off:off + half], jv[:, off:off + half],
            half, off, block_q=32, block_k=32, interpret=True,
        )
        to, tl = tattn.flash_attention_with_lse(
            tq[:, half:], tk[:, off:off + half], tv[:, off:off + half],
            half, off,
        )
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        parts.append((to, tl))
    (oa, la), (ob, lb) = parts
    m = torch.maximum(la, lb)
    wa = torch.exp(la - m)[..., None]
    wb = torch.exp(lb - m)[..., None]
    merged = (oa.transpose(1, 2) * wa + ob.transpose(1, 2) * wb) / (wa + wb)
    full = jattn.flash_attention(jq, jk, jv, causal=True, block_q=32,
                                 block_k=32, interpret=True)[:, half:]
    np.testing.assert_allclose(merged.transpose(1, 2).numpy(),
                               np.asarray(full), **TOL)


def test_fully_masked_chunk_is_zero_weight():
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(4, B=1, S=64, H=1, hd=32))
    jo, jl = jattn.flash_attention_with_lse(jq, jk, jv, 0, 10_000, block_q=32,
                                            block_k=32, interpret=True)
    to, tl = tattn.flash_attention_with_lse(tq, tk, tv, 0, 10_000)
    assert torch.all(tl < -1e29)
    assert torch.all(to == 0)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_rows_without_visible_key_are_zero():
    """q rows before the kv chunk's first position see no key: o = 0 and
    lse = -1e30, while the rows that do see keys are plain attention."""
    _, (tq, tk, tv) = both(make_qkv(5, B=1, S=64, H=2, hd=32))
    o, lse = tattn.flash_attention_with_lse(tq, tk, tv, 0, 32)
    assert torch.all(o[:, :32] == 0) and torch.all(lse[..., :32] == -1e30)
    ref, _ = tattn.flash_attention_with_lse(tq[:, 32:], tk[:, :32], tv[:, :32],
                                            32, 32)
    torch.testing.assert_close(o[:, 32:], ref, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_gradients_match_jax(causal):
    """On the CPU the backward is the plain backward (mha_backward_plain);
    it must match the JAX custom VJP (the Pallas backward, interpret
    mode)."""
    arrays = make_qkv(2, B=1, S=128, H=2, hd=32)
    (jq, jk, jv), _ = both(arrays)

    def jloss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, block_q=32,
                                  block_k=32, interpret=True)
        return jnp.sum(jnp.sin(o))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tqkv = [torch.from_numpy(a).requires_grad_() for a in arrays]
    torch.sin(tattn.flash_attention(*tqkv, causal=causal)).sum().backward()
    for t, j in zip(tqkv, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=5e-4, rtol=5e-4)


def test_bf16_plain_rounds_like_the_tpu_kernel():
    """In bf16 the scale is folded into q in bf16 and p is cast to bf16
    before p.v: the plain version must equal that arithmetic written out."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 96, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    o, lse = tattn.mha_forward_plain(q, k, v, causal=True)
    qs = (q * torch.tensor(0.125, dtype=torch.bfloat16)).float()
    s = qs @ k.float().transpose(-1, -2)
    s = s.masked_fill(~torch.ones(96, 96, dtype=torch.bool).tril(), -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    ref = (p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)
    torch.testing.assert_close(o, ref.bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(
        lse, (m + torch.log(p.sum(-1, keepdim=True)))[..., 0], **TOL)


def _imports(path, top_level=False):
    """The modules a file imports; with top_level, only those imported at
    module level (not inside a function or class)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in (tree.body if top_level else ast.walk(tree)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_ray_tpu():
    """Nor transformers, which the GPU machine does not have: Llama's
    params_from_hf takes a model the caller built. The rank processes of
    the multi-process tests (tests/torch_parallel_ranks.py) import no JAX
    either. pyarrow and pandas, which the GPU machine may lack, are
    imported only inside the functions that read or write files, never at
    a module's top level."""
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "torch_parallel_ranks.py"]
    assert len(files) > 5
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"ray_tpu_torch/models/llama.py", "ray_tpu_torch/ops/moe.py",
            "ray_tpu_torch/train/train_step.py",
            "ray_tpu_torch/parallel/mesh.py",
            "ray_tpu_torch/parallel/sharding.py",
            "ray_tpu_torch/parallel/pipeline.py",
            "ray_tpu_torch/parallel/tensor.py",
            "ray_tpu_torch/rllib/learner.py",
            "ray_tpu_torch/rllib/models.py",
            "ray_tpu_torch/rllib/algorithm.py",
            "ray_tpu_torch/rllib/replay_buffers.py",
            "ray_tpu_torch/rllib/offline.py",
            "ray_tpu_torch/rllib/algorithms/dqn.py",
            "ray_tpu_torch/rllib/algorithms/sac.py",
            "ray_tpu_torch/rllib/algorithms/bc.py",
            "ray_tpu_torch/tune/trainable.py",
            "ray_tpu_torch/api.py",
            "ray_tpu_torch/actor.py",
            "ray_tpu_torch/remote_function.py",
            "ray_tpu_torch/exceptions.py",
            "ray_tpu_torch/core/ids.py",
            "ray_tpu_torch/core/options.py",
            "ray_tpu_torch/core/refs.py",
            "ray_tpu_torch/core/resources.py",
            "ray_tpu_torch/core/serialization.py",
            "ray_tpu_torch/core/config.py",
            "ray_tpu_torch/core/backend.py",
            "ray_tpu_torch/core/local_backend.py",
            "ray_tpu_torch/util/backoff.py",
            "ray_tpu_torch/train/config.py",
            "ray_tpu_torch/train/session.py",
            "ray_tpu_torch/train/checkpoint.py",
            "ray_tpu_torch/train/worker_group.py",
            "ray_tpu_torch/train/trainer.py",
            "ray_tpu_torch/core/rpc.py",
            "ray_tpu_torch/core/task_spec.py",
            "ray_tpu_torch/core/scheduling_policy.py",
            "ray_tpu_torch/core/gcs/wal.py",
            "ray_tpu_torch/core/gcs/server.py",
            "ray_tpu_torch/core/object_store/lifecycle.py",
            "ray_tpu_torch/core/object_store/shm_store.py",
            "ray_tpu_torch/core/raylet/worker_pool.py",
            "ray_tpu_torch/core/raylet/log_monitor.py",
            "ray_tpu_torch/core/raylet/node_manager.py",
            "ray_tpu_torch/core/core_worker.py",
            "ray_tpu_torch/core/worker_main.py",
            "ray_tpu_torch/core/cluster_backend.py",
            "ray_tpu_torch/util/placement_group.py",
            "ray_tpu_torch/data/__init__.py",
            "ray_tpu_torch/data/block.py",
            "ray_tpu_torch/data/datasource.py",
            "ray_tpu_torch/data/executor.py",
            "ray_tpu_torch/data/shuffle.py",
            "ray_tpu_torch/data/dataset.py",
            "ray_tpu_torch/data/iterator.py",
            "ray_tpu_torch/data/preprocessors.py",
            "ray_tpu_torch/train/batch_predictor.py"} <= names
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "ray_tpu", "optax", "orbax",
                                  "flax", "transformers")
    ]
    assert not bad, bad
    eager = [
        (str(f.relative_to(REPO)), name)
        for f in files for name in _imports(f, top_level=True)
        if name.split(".")[0] in ("pyarrow", "pandas")
    ]
    assert not eager, eager
