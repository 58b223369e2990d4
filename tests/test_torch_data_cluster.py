"""Port vs reference: the Data layer and its consumers on the multi-process
runtime, one ray_tpu and one ray_tpu_torch cluster for the module
(num_cpus=4 each: two train workers or two pool actors leave CPUs for the
read and map tasks that feed them, so no stage waits on another for a CPU).

- The actor-pool map; the distributed random shuffle (the same
  permutation), sort (ascending and descending, partitioned output) and
  groupby with string keys across worker processes (every key in one
  partition), against the reference's rows.
- TorchTrainer(datasets=) with 2 CPU workers: each rank sees its 32-row
  shard three times, as tests/test_data.py checks, and its rows are the
  reference's split's.
- BatchPredictor with the linear model of tests/test_train_jax_trainer.py
  against JaxPredictor's output (1e-6), pass-through columns kept.
- The slice as a whole: gpt2_tiny's weights from JAX carried across
  (params_from_jax), served over a Dataset through BatchPredictor in both
  packages: next_token equal, logit within tests/test_torch_gpt2.py's f32
  tolerance (1e-4).
- An actor whose constructor argument is past the inline limit starts
  (the path of BatchPredictor's checkpoint to each actor); a predictor on
  a card gives its pool one GPU an actor.
- Nothing of the port's cluster is left after shutdown.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from torch_cluster_pairs import assert_nothing_left, port_identity

F32_LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def clusters():
    for ray in (ray_tpu, ray_tpu_torch):
        ray.shutdown()
    ray_tpu.init(num_cpus=4, num_tpus=0)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield port_identity()
    for ray in (ray_tpu, ray_tpu_torch):
        ray.shutdown()


def both(program):
    """program(rd) through each package's data module; returns both."""
    return program(jdata), program(tdata)


def test_actor_pool_map(clusters):
    def program(rd):
        class AddConst:
            def __init__(self, c):
                self.c = c

            def __call__(self, block):
                return {"id": block["id"] + self.c, "pid": np.full(
                    len(block["id"]), __import__("os").getpid())}

        ds = rd.range(40, parallelism=4).map_batches(
            AddConst, fn_args=(1000,),
            compute=rd.ActorPoolStrategy(size=2))
        rows = ds.take_all()
        return [int(r["id"]) for r in rows], {int(r["pid"]) for r in rows}

    (ref, _), (port, pids) = both(program)
    assert port == ref == list(range(1000, 1040))
    import os

    assert os.getpid() not in pids and len(pids) == 2


def test_distributed_random_shuffle_is_the_references(clusters):
    def program(rd):
        out = rd.range(200, parallelism=4).random_shuffle(seed=3)
        blocks = [len(b["id"]) for b in out.iter_batches(batch_size=10_000)]
        return [int(r["id"]) for r in out.take_all()], blocks

    ref, port = both(program)
    assert port == ref
    assert sorted(port[0]) == list(range(200)) and port[0] != list(range(200))


@pytest.mark.parametrize("descending", [False, True])
def test_distributed_sort_is_the_references(clusters, descending):
    vals = np.random.default_rng(7).permutation(500).astype(np.int64)

    def program(rd):
        ds = rd.from_items([{"v": int(v)} for v in vals], parallelism=8)
        out = ds.sort("v", descending=descending, num_partitions=4)
        return len(list(out.iter_block_refs())), [int(r["v"]) for r in out.take_all()]

    ref, port = both(program)
    assert port == ref
    assert port[0] == 4 and port[1] == sorted(range(500), reverse=descending)


def test_groupby_string_keys_across_processes(clusters):
    keys = ["alpha", "beta", "gamma", "delta", "epsilon"]
    items = [{"k": keys[i % 5], "v": float(i)} for i in range(200)]

    def program(rd):
        def count(group):
            return {"k": group["k"][:1],
                    "n": np.asarray([len(np.asarray(group["v"]))]),
                    "pid": np.asarray([__import__("os").getpid()])}

        out = rd.from_items(items, parallelism=8).groupby("k").map_groups(
            count, num_partitions=4)
        rows = out.take_all()
        return (sorted((str(r["k"]), int(r["n"])) for r in rows),
                len({int(r["pid"]) for r in rows}))

    (ref, _), (port, _) = both(program)
    assert port == ref == sorted((k, 40) for k in keys)


def test_torch_trainer_feeds_from_a_dataset(clusters):
    """tests/test_data.py's trainer case on the port: 2 CPU workers, each
    sees its 32-row shard three times; the rows each rank saw are the
    reference's split of the same dataset."""
    from ray_tpu_torch.train import (
        ScalingConfig, TorchTrainer, get_dataset_shard, report,
    )

    def make(rd):
        return rd.range(64, parallelism=4).map_batches(
            lambda b: {"x": b["id"].astype(np.float32),
                       "y": (b["id"] * 3 + 1).astype(np.float32)})

    def train_loop(config):
        shard = get_dataset_shard("train")
        w = torch.zeros(2)
        seen, xs = 0, []
        for epoch in range(3):
            for batch in shard.iter_batches(batch_size=8, device="cpu"):
                x, y = batch["x"], batch["y"]
                seen += int(x.shape[0])
                if epoch == 0:
                    xs.extend(x.tolist())
                w = w.requires_grad_(True)
                loss = torch.mean((w[0] * x + w[1] - y) ** 2)
                (g,) = torch.autograd.grad(loss, w)
                w = (w - 0.01 * g).detach()
        report({"rows_seen": seen, "xs": xs})

    result = TorchTrainer(
        train_loop, scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": make(tdata)}).fit()
    assert result.error is None
    assert result.metrics["rows_seen"] == 96
    ranks = result.metrics["_all_ranks"]
    assert set(ranks) == {0, 1}
    assert all(m["rows_seen"] == 96 for m in ranks.values())
    want = [[float(r["x"]) for r in s.take_all()] for s in make(jdata).split(2)]
    assert [ranks[r]["xs"] for r in (0, 1)] == want


def test_batch_predictor_linear_model_matches_jax_predictor(clusters):
    from ray_tpu.train import BatchPredictor as JBatchPredictor
    from ray_tpu.train import Checkpoint as JCheckpoint
    from ray_tpu.train import JaxPredictor
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, TorchPredictor

    w = np.asarray([[2.0], [1.0]], np.float32)
    b = np.asarray([0.5], np.float32)
    rows = [{"x0": float(i), "x1": float(2 * i), "id": i} for i in range(64)]

    def japply(params, batch):
        x = jnp.stack([jnp.asarray(batch["x0"]), jnp.asarray(batch["x1"])], -1)
        return {"y": (x @ params["w"] + params["b"])[:, 0]}

    def tapply(params, batch):
        x = torch.stack([batch["x0"], batch["x1"]], -1).float()
        return {"y": (x @ params["w"] + params["b"])[:, 0]}

    ref = JBatchPredictor.from_checkpoint(
        JCheckpoint.from_dict({"params": {"w": w, "b": b}}), JaxPredictor,
        apply_fn=japply).predict(jdata.from_items(rows, parallelism=4),
                                 num_workers=2, keep_columns=("id",))
    port = BatchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": {"w": torch.from_numpy(w),
                                         "b": torch.from_numpy(b)}}),
        TorchPredictor, apply_fn=tapply, device="cpu",
    ).predict(tdata.from_items(rows, parallelism=4), num_workers=2,
              keep_columns=("id",))
    want = {int(r["id"]): float(r["y"]) for r in ref.take_all()}
    got = {int(r["id"]): float(r["y"]) for r in port.take_all()}
    assert sorted(got) == sorted(want) == list(range(64))
    np.testing.assert_allclose([got[i] for i in range(64)],
                               [want[i] for i in range(64)], rtol=1e-6)
    np.testing.assert_allclose([got[i] for i in range(64)],
                               [4.0 * i + 0.5 for i in range(64)], rtol=1e-6)


def test_the_slice_gpt2_tiny_served_over_a_dataset(clusters, tmp_path):
    """gpt2_tiny (f32) from JAX's init, carried across, serves the same
    Dataset of token rows in both packages through BatchPredictor on a
    pool of two actors. The port's checkpoint crosses the store to each
    actor as a dict; the reference's goes as a directory, since its
    runtime frees an actor's constructor argument past the inline limit
    before the actor fetches it (ROADMAP.md Queue C)."""
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.train import BatchPredictor as JBatchPredictor
    from ray_tpu.train import Checkpoint as JCheckpoint
    from ray_tpu.train import JaxPredictor
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, TorchPredictor
    from ray_tpu_torch.train.train_step import synthetic_batch

    jcfg = jgpt2.gpt2_tiny(dtype=jnp.float32, attention_impl="xla")
    tcfg = tgpt2.gpt2_tiny(dtype=torch.float32)
    jparams = jax.tree.map(np.asarray, jgpt2.init(jcfg, jax.random.PRNGKey(1)))
    tokens = np.concatenate([synthetic_batch(tcfg, 4, seed=i)["tokens"]
                             for i in range(3)])
    rows = [{"id": i, "tokens": t} for i, t in enumerate(tokens)]

    def japply(params, batch):
        logits = jgpt2.forward(params, batch["tokens"], jcfg)[:, -1, :jcfg.vocab_size]
        return {"next_token": jnp.argmax(logits, -1), "logit": jnp.max(logits, -1)}

    def tapply(params, batch):
        logits = tgpt2.forward(params, batch["tokens"], tcfg)[:, -1, :tcfg.vocab_size]
        best = logits.float().max(dim=-1)
        return {"next_token": best.indices, "logit": best.values}

    def answers(out):
        rows = sorted(out.take_all(), key=lambda r: int(r["id"]))
        return (np.asarray([int(r["next_token"]) for r in rows]),
                np.asarray([float(r["logit"]) for r in rows]))

    jckpt = JCheckpoint.from_directory(
        JCheckpoint.from_dict({"params": jparams}).to_directory(str(tmp_path)))
    ref = answers(JBatchPredictor.from_checkpoint(
        jckpt, JaxPredictor, apply_fn=japply,
    ).predict(jdata.from_items(rows, parallelism=3), batch_size=4,
              num_workers=2, keep_columns=("id",)))
    port = answers(BatchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": tgpt2.params_from_jax(jparams, device="cpu")}),
        TorchPredictor, apply_fn=tapply, device="cpu",
    ).predict(tdata.from_items(rows, parallelism=3), batch_size=4,
              num_workers=2, keep_columns=("id",)))
    assert len(port[0]) == 12
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_allclose(port[1], ref[1], **F32_LOGIT_TOL)


@pytest.mark.parametrize("mib", [1, 64])
def test_an_actor_takes_a_constructor_argument_past_the_inline_limit(clusters, mib):
    """A constructor argument larger than the inline limit (100 KiB) goes
    to the store as a ref only the creation task holds; the owner pins it
    while the actor may start, so the actor gets it (BatchPredictor's
    checkpoint takes this way to every actor of its pool)."""
    @ray_tpu_torch.remote(num_cpus=0)
    class Holder:
        def __init__(self, tree):
            self.total = float(sum(t.sum() for t in tree.values()))

        def total_(self):
            return self.total

    tree = {"w": torch.ones(mib * 2 ** 18), "b": torch.full((3,), 2.0)}
    actor = Holder.remote(tree)
    assert ray_tpu_torch.get(actor.total_.remote(), timeout=60) == \
        mib * 2 ** 18 + 6.0
    ray_tpu_torch.kill(actor)


def test_a_card_predictor_leases_a_gpu_per_actor():
    """BatchPredictor's pool asks for one GPU an actor when the predictor
    runs on a card, none on the CPU (no cluster needed: the plan only)."""
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, TorchPredictor

    ck = Checkpoint.from_dict({"params": {}})
    ds = tdata.from_items([1, 2])
    for kwargs, gpus in (({}, 1), ({"device": "cuda:0"}, 1), ({"device": "cpu"}, 0)):
        op = BatchPredictor(ck, TorchPredictor, apply_fn=None, **kwargs).predict(
            ds, num_workers=3)._ops[-1]
        assert (op.compute.size, op.compute.num_gpus) == (3, gpus)


def test_nothing_left_after_shutdown(clusters):
    assert_nothing_left(clusters)
