"""Port vs reference: TorchTrainer on the in-process runtime
(ray_tpu_torch/train/trainer.py, worker_group.py, session.py) against
JaxTrainer on ray_tpu's local mode.

- The three tests of tests/test_train_jax_trainer.py:70-121 (BASELINE
  config 1's MLP, 784 → 128 → 10, Adam 1e-2: it learns in 12 steps,
  resumes from its checkpoint, a failing loop surfaces its error), each
  loop in both packages from the same numpy weights and data: the losses
  agree within 2e-5 absolute (float32 sums in other orders, which Adam's
  steps carry on, each weight moving by about the learning rate whatever
  its gradient: measured up to 6.5e-6 over 12 steps, the loss falling
  from 2.4 to 4e-5, where relative differences mean nothing).
- Parity of the GPT-2 train step through the trainers: gpt2_tiny in f32
  ("xla" attention in both: the kernels' own parity is
  test_torch_train_step.py's), 3 steps through JaxTrainer with ray_tpu's
  make_gpt2_train_step and through TorchTrainer with the port's, from the
  same params (gpt2.params_from_jax): losses at 1e-5 absolute, grad norms at 1e-5
  relative and the final params restored from each package's checkpoint at
  1e-5, the tolerances of test_torch_train_step.py::
  test_three_train_steps_match_jax.
- FailureConfig's retry from the latest checkpoint, the session's context,
  as_trainable through tune/trainable.py's wrap_function: the same loop
  (written against either package's train module) under both.
- num_workers=2 is refused under the in-process runtime (ray_tpu's local
  mode fails there too, with an AttributeError: ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.train as jtrain_api
import ray_tpu_torch
import ray_tpu_torch.train as ttrain_api

MLP_LR = 1e-2
MLP_LOSS_ATOL = 2e-5


@pytest.fixture
def local_modes():
    for ray in (ray_tpu, ray_tpu_torch):
        ray.shutdown()
        ray.init(local_mode=True)
    yield
    for ray in (ray_tpu, ray_tpu_torch):
        ray.shutdown()


def mlp_start():
    """784 → 128 → 10 weights and a 256-row batch, from numpy."""
    rng = np.random.default_rng(0)
    params = {"w1": (rng.standard_normal((784, 128)) * 0.05).astype(np.float32),
              "b1": np.zeros(128, np.float32),
              "w2": (rng.standard_normal((128, 10)) * 0.05).astype(np.float32),
              "b2": np.zeros(10, np.float32)}
    x = rng.standard_normal((256, 784)).astype(np.float32)
    y = (np.arange(256) % 10).astype(np.int32)
    return params, x, y


def jax_mlp_loop(config):
    """tests/test_train_jax_trainer.py's mlp_train_loop, from numpy weights."""
    import optax

    from ray_tpu import train

    params, x, y = mlp_start()
    params = jax.tree.map(jnp.asarray, params)
    ckpt = train.get_checkpoint()
    start_step = 0
    if ckpt is not None:
        restored = ckpt.to_jax(target=jax.device_get(params))
        params = restored["params"] if "params" in restored else restored
        start_step = int(restored.get("step", 0)) if isinstance(restored, dict) else 0
    opt = optax.adam(MLP_LR)
    opt_state = opt.init(params)

    def loss_fn(p, x, y):
        h = jax.nn.relu(x @ p["w1"] + p["b1"])
        logits = h @ p["w2"] + p["b2"]
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    @jax.jit
    def step(p, s, x, y):
        loss, g = jax.value_and_grad(loss_fn)(p, x, y)
        updates, s = opt.update(g, s)
        return optax.apply_updates(p, updates), s, loss

    num_steps = config.get("num_steps", 10)
    for i in range(start_step, start_step + num_steps):
        params, opt_state, loss = step(params, opt_state, x, y)
        if (i + 1) % 5 == 0 or i == start_step + num_steps - 1:
            ck = train.Checkpoint.from_jax({"params": params, "step": i + 1})
            train.report({"loss": float(loss), "step": i + 1}, checkpoint=ck)
        else:
            train.report({"loss": float(loss), "step": i + 1})


def torch_mlp_loop(config):
    """The same loop on the port: torch.optim.Adam (optax.adam's update),
    from_torch checkpoints restored into the initial params."""
    import torch.nn.functional as F

    from ray_tpu_torch import train

    start, x, y = mlp_start()
    params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in start.items()}
    x, y = torch.from_numpy(x), torch.from_numpy(y).long()
    ckpt = train.get_checkpoint()
    start_step = 0
    if ckpt is not None:
        restored = ckpt.to_torch(target={"params": params, "step": 0})
        start_step = restored["step"]
    opt = torch.optim.Adam(list(params.values()), lr=MLP_LR, eps=1e-8)

    num_steps = config.get("num_steps", 10)
    for i in range(start_step, start_step + num_steps):
        opt.zero_grad()
        h = torch.relu(x @ params["w1"] + params["b1"])
        loss = F.cross_entropy(h @ params["w2"] + params["b2"], y)
        loss.backward()
        opt.step()
        if (i + 1) % 5 == 0 or i == start_step + num_steps - 1:
            ck = train.Checkpoint.from_torch(
                {"params": {k: v.detach() for k, v in params.items()}, "step": i + 1})
            train.report({"loss": loss.item(), "step": i + 1}, checkpoint=ck)
        else:
            train.report({"loss": loss.item(), "step": i + 1})


def fit_both(config, resume=(None, None), **kwargs):
    ref = jtrain_api.JaxTrainer(
        jax_mlp_loop, train_loop_config=config, resume_from_checkpoint=resume[0],
        scaling_config=jtrain_api.ScalingConfig(num_workers=1), **kwargs).fit()
    port = ttrain_api.TorchTrainer(
        torch_mlp_loop, train_loop_config=config, resume_from_checkpoint=resume[1],
        scaling_config=ttrain_api.ScalingConfig(num_workers=1), **kwargs).fit()
    return ref, port


def losses(result):
    return [m["loss"] for m in result.metrics_dataframe]


# ------------------------------------------ tests/test_train_jax_trainer.py

def test_torch_trainer_mlp_learns(local_modes):
    ref, port = fit_both({"num_steps": 12})
    for r in (ref, port):
        assert r.error is None and r.checkpoint is not None
        assert len(losses(r)) == 12
        assert losses(r)[-1] < losses(r)[0] * 0.7, losses(r)
        assert [m["step"] for m in r.metrics_dataframe] == list(range(1, 13))
    np.testing.assert_allclose(losses(port), losses(ref), rtol=0, atol=MLP_LOSS_ATOL)
    assert port.metrics["step"] == ref.metrics["step"] == 12


def test_torch_trainer_resume_from_checkpoint(local_modes):
    first = fit_both({"num_steps": 5})
    assert all(r.error is None and r.checkpoint is not None for r in first)
    second = fit_both({"num_steps": 5}, resume=tuple(r.checkpoint for r in first))
    for r in second:
        assert r.error is None
        assert r.metrics["step"] == 10   # resumed run continues from step 5
    np.testing.assert_allclose(losses(second[1]), losses(second[0]), rtol=0,
                               atol=MLP_LOSS_ATOL)
    # the loop checkpoints the params alone (Adam restarts), so the resumed
    # run's first loss, taken before its first update, is the straight
    # run's sixth, bitwise (one process, the same sums)
    straight = fit_both({"num_steps": 10})
    assert losses(second[1])[0] == losses(straight[1])[5]


def test_trainer_failure_surfaces(local_modes):
    def bad_loop(config):
        raise RuntimeError("train exploded")

    for api, trainer in ((jtrain_api, jtrain_api.JaxTrainer),
                         (ttrain_api, ttrain_api.TorchTrainer)):
        result = trainer(bad_loop, scaling_config=api.ScalingConfig(num_workers=1)).fit()
        assert result.error is not None
        assert type(result.error).__name__ == "RuntimeError"
        assert "train exploded" in str(result.error)


# ---------------------------------------------------- the GPT-2 step, parity

def jax_gpt2_loop(config):
    from ray_tpu import train
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.parallel import mesh as mesh_lib
    from ray_tpu.train import train_step as jstep

    cfg = jgpt2.gpt2_tiny(dtype=jnp.float32, attention_impl="xla")
    bundle = jstep.make_gpt2_train_step(
        cfg, mesh=mesh_lib.single_device_mesh(),
        optimizer=jstep.default_optimizer(warmup=2, total_steps=10),
        rng=jax.random.PRNGKey(0))
    state = bundle.state
    config["start"] = jax.device_get(state["params"])    # for the port's loop
    for i in range(config["steps"]):
        state, m = bundle.step_fn(state, jstep.synthetic_batch(cfg, 2, seed=i))
        last = i == config["steps"] - 1
        train.report(
            {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "step": i + 1},
            checkpoint=train.Checkpoint.from_jax(
                {"params": state["params"], "step": i + 1}) if last else None)


def torch_gpt2_loop(config):
    from ray_tpu_torch import train
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.train import train_step as tstep

    cfg = tgpt2.gpt2_tiny(dtype=torch.float32, attention_impl="xla")
    bundle = tstep.make_gpt2_train_step(
        cfg, optimizer=tstep.default_optimizer(warmup=2, total_steps=10),
        device="cpu")
    start = dict(tstep.named_leaves(tgpt2.params_from_jax(config["start"], device="cpu")))
    with torch.no_grad():
        for name, dst in tstep.named_leaves(bundle.state["params"]):
            dst.copy_(start[name])
    state = bundle.state
    for i in range(config["steps"]):
        state, m = bundle.step_fn(state, tstep.synthetic_batch(cfg, 2, seed=i))
        last = i == config["steps"] - 1
        train.report(
            {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(), "step": i + 1},
            checkpoint=train.Checkpoint.from_torch(
                {"params": state["params"], "opt_state": state["opt_state"].state_dict(),
                 "step": state["step"]}) if last else None)


def test_gpt2_steps_through_both_trainers_match(local_modes):
    config = {"steps": 3}        # local mode: both loops share this dict
    ref = jtrain_api.JaxTrainer(jax_gpt2_loop, train_loop_config=config).fit()
    port = ttrain_api.TorchTrainer(torch_gpt2_loop, train_loop_config=config).fit()
    assert ref.error is None and port.error is None
    for r, t in zip(ref.metrics_dataframe, port.metrics_dataframe):
        assert r["step"] == t["step"]
        assert t["loss"] == pytest.approx(r["loss"], abs=1e-5)
        assert t["grad_norm"] == pytest.approx(r["grad_norm"], rel=1e-5)
    assert len(port.metrics_dataframe) == 3
    jparams = ref.checkpoint.to_jax()["params"]
    tparams = port.checkpoint.to_torch()["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = tparams
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.numpy(), np.asarray(leaf), atol=1e-5, rtol=0,
                                   err_msg=str(path))


# ------------------------------------------------- the same loop, both packages

def counting_loop(config):
    """Written against `config["train"]` (either package's train module):
    checkpoints every step as a dict, fails once after step
    config["fail_after"] on the first attempt, resumes from the session's
    checkpoint."""
    train = config["train"]
    config["attempts"].append(train.get_context().world_rank)
    ckpt = train.get_checkpoint()
    step = ckpt.to_dict()["step"] if ckpt is not None else 0
    config["starts"].append(step)
    while step < config["until"]:
        step += 1
        if len(config["attempts"]) == 1 and step == config.get("fail_after"):
            raise RuntimeError(f"injected failure after step {step}")
        train.report({"step": step, "square": step * step},
                     checkpoint=train.Checkpoint.from_dict({"step": step}))


@pytest.mark.parametrize("failures", [0, 1])
def test_failure_config_retries_from_the_latest_checkpoint(local_modes, failures):
    outcomes = []
    for api, trainer in ((jtrain_api, jtrain_api.JaxTrainer),
                         (ttrain_api, ttrain_api.TorchTrainer)):
        config = {"train": api, "attempts": [], "starts": [], "until": 5,
                  "fail_after": 3}
        result = trainer(
            counting_loop, train_loop_config=config,
            run_config=api.RunConfig(failure_config=api.FailureConfig(max_failures=failures)),
        ).fit()
        outcomes.append((type(result.error).__name__, str(result.error),
                         [m["step"] for m in result.metrics_dataframe],
                         result.checkpoint.to_dict(), config["starts"]))
    assert outcomes[1] == outcomes[0]
    if failures:
        assert outcomes[0] == ("NoneType", "None", [1, 2, 3, 4, 5], {"step": 5}, [0, 2])
    else:
        assert outcomes[0] == ("RuntimeError", "injected failure after step 3",
                               [1, 2], {"step": 2}, [0])


def test_session_context_and_datasets(local_modes):
    def loop(config):
        train = config["train"]
        ctx = train.get_context()
        train.report({"rank": train.get_world_rank(), "size": train.get_world_size(),
                      "local": train.get_local_rank(), "name": ctx.experiment_name,
                      "shard": train.get_dataset_shard("train")})

    rows = []
    for api, trainer in ((jtrain_api, jtrain_api.JaxTrainer),
                         (ttrain_api, ttrain_api.TorchTrainer)):
        r = trainer(loop, train_loop_config={"train": api},
                    run_config=api.RunConfig(name="exp"),
                    datasets={"train": [1, 2, 3]}).fit()
        rows.append({k: v for k, v in r.metrics.items() if k != "_all_ranks"})
    assert rows[1] == rows[0] == {"rank": 0, "size": 1, "local": 0, "name": "exp",
                                  "shard": [1, 2, 3]}
    for api in (jtrain_api, ttrain_api):
        with pytest.raises(RuntimeError, match="No train session"):
            api.report({})


def test_as_trainable_through_wrap_function(local_modes):
    from ray_tpu.tune.trainable import wrap_function as ref_wrap
    from ray_tpu_torch.tune.trainable import wrap_function

    out = []
    for api, trainer, wrap in ((jtrain_api, jtrain_api.JaxTrainer, ref_wrap),
                               (ttrain_api, ttrain_api.TorchTrainer, wrap_function)):
        fn = trainer(counting_loop, train_loop_config={"train": api}).as_trainable()
        t = wrap(fn)({"attempts": [], "starts": [], "until": 4})
        result = t.train()
        out.append({k: v for k, v in result.items()
                    if k not in ("time_this_iter_s", "time_total_s", "_all_ranks")})
    assert out[1] == out[0] == {"step": 4, "square": 16, "done": True,
                                "training_iteration": 1, "timesteps_total": 0}


def test_more_than_one_worker_is_refused_in_local_mode(local_modes):
    def loop(config):
        pass

    with pytest.raises(AttributeError, match="create_placement_group"):
        jtrain_api.JaxTrainer(loop, scaling_config=jtrain_api.ScalingConfig(
            num_workers=2)).fit()
    with pytest.raises(NotImplementedError, match="multi-process runtime"):
        ttrain_api.TorchTrainer(loop, scaling_config=ttrain_api.ScalingConfig(
            num_workers=2, use_gpu=True)).fit()


def test_scaling_config_asks_for_gpus():
    cfg = ttrain_api.ScalingConfig(num_workers=1, use_gpu=True, gpus_per_worker=2,
                                   resources_per_worker={"CPU": 4})
    assert cfg.worker_resources() == {"CPU": 4, "GPU": 2.0}
    assert ttrain_api.ScalingConfig().worker_resources() == {"CPU": 1.0}
    assert (jtrain_api.ScalingConfig(use_tpu=True).worker_resources()
            == {"CPU": 1.0, "TPU": 1.0})


def test_setup_torch_distributed_is_re_entrant():
    import socket

    import torch.distributed as dist

    from ray_tpu_torch.train.worker_group import TrainWorker

    w = TrainWorker(0, 1)
    try:
        for _ in range(2):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            assert w.setup_torch_distributed(f"127.0.0.1:{port}", 1, 0)
            assert dist.is_initialized() and dist.get_backend() == "gloo"
            assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
