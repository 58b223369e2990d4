"""Port vs reference: the device seam of the Data layer
(ray_tpu_torch.data.iterator against ray_tpu.data.iterator), each package
under its own in-process runtime.

- iter_batches and iter_stacked_batches with device="cpu" give CPU
  tensors equal in value to the reference's jax.Arrays on the CPU device
  (its `device=` and `stacked_sharding=`), in the same order and sizes,
  with the host batch's dtype (JAX without x64 holds int64 as int32;
  torch keeps int64); with no device both give the same numpy batches.
- Exact batch sizes and drop_last; `sharding` applied to each host batch
  before the copy; the prefetch window issues `prefetch_batches` copies
  ahead of the batch yielded.
- No fallback: device="cuda" without a card raises, and a string column
  bound for a device raises a TypeError naming it.
- On the card (marked cuda, skipped here): the pinned copy-stream path,
  bitwise over 50 batches of two columns of one shape whose consumer
  writes into each batch in place, with the staging buffers reused. The
  file imports JAX only in the reference's fixture, so that test runs
  where JAX is not installed: `python -m pytest --noconftest -m cuda
  tests/test_torch_data_iterator.py`.
"""

import types

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as tdata
from ray_tpu_torch.data import iterator as titer


@pytest.fixture(scope="module", autouse=True)
def port_runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def ref():
    """The reference's data layer under its in-process runtime."""
    import jax

    import ray_tpu
    from ray_tpu import data as jdata
    from ray_tpu.data import iterator as jiter

    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True)
    yield types.SimpleNamespace(jax=jax, data=jdata, iterator=jiter)
    ray_tpu.shutdown()


def table(rd, n=70, parallelism=3, seed=0):
    """A seeded dataset of int64, f32 and bool columns, one of them 2-d."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    flags = rng.random(n) < 0.5
    return rd.from_items([{"id": ids[i], "x": x[i], "flag": flags[i]}
                          for i in range(n)], parallelism=parallelism)


def same(tensor, array, dtype):
    """A CPU tensor of `dtype` equal in value and shape to a jax array."""
    want = np.asarray(array)
    assert isinstance(tensor, torch.Tensor) and tensor.device.type == "cpu"
    assert tensor.numpy().dtype == dtype and tensor.shape == want.shape
    assert np.array_equal(tensor.numpy(), want)


DTYPES = {"id": np.int64, "x": np.float32, "flag": np.bool_}


@pytest.mark.parametrize("batch_size,drop_last", [(32, False), (32, True),
                                                  (7, False), (100, False)])
@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_iter_batches_on_the_cpu_match_the_reference(ref, batch_size,
                                                     drop_last, prefetch):
    cpu = ref.jax.devices("cpu")[0]
    want_batches = list(table(ref.data).iter_batches(
        batch_size=batch_size, drop_last=drop_last, prefetch_batches=prefetch,
        device=cpu))
    port = list(table(tdata).iter_batches(
        batch_size=batch_size, drop_last=drop_last, prefetch_batches=prefetch,
        device="cpu"))
    assert len(port) == len(want_batches)
    for got, want in zip(port, want_batches):
        assert set(got) == set(want)
        assert isinstance(want["x"], ref.jax.Array)
        for k in want:
            same(got[k], want[k], DTYPES[k])


def test_host_batches_match_the_reference(ref):
    want_batches = list(table(ref.data).iter_batches(batch_size=16))
    port = list(table(tdata).iter_batches(batch_size=16))
    assert len(port) == len(want_batches)
    for got, want in zip(port, want_batches):
        assert all(isinstance(v, np.ndarray) for v in got.values())
        assert {k: (v.dtype, v.tolist()) for k, v in got.items()} == \
            {k: (v.dtype, v.tolist()) for k, v in want.items()}


@pytest.mark.parametrize("rows,batch_size,steps", [(70, 16, 2), (64, 8, 4),
                                                   (30, 16, 2)])
def test_iter_stacked_batches_match_the_reference(ref, rows, batch_size, steps):
    sh = ref.jax.sharding.SingleDeviceSharding(ref.jax.devices("cpu")[0])
    want_stacks = list(ref.iterator.iter_stacked_batches(
        table(ref.data, rows).iter_block_refs(), batch_size=batch_size,
        steps_per_stack=steps, stacked_sharding=sh))
    port = list(titer.iter_stacked_batches(
        table(tdata, rows).iter_block_refs(), batch_size=batch_size,
        steps_per_stack=steps, device="cpu"))
    host = list(titer.iter_stacked_batches(
        table(tdata, rows).iter_block_refs(), batch_size=batch_size,
        steps_per_stack=steps))
    assert len(port) == len(want_stacks) == len(host) == rows // batch_size // steps
    for got, want, h in zip(port, want_stacks, host):
        assert got["x"].shape == (steps, batch_size, 3)
        for k in want:
            same(got[k], want[k], DTYPES[k])
            assert h[k].dtype == DTYPES[k]
            assert np.array_equal(h[k], np.asarray(want[k]))


def test_exact_sizes_and_drop_last():
    ds = tdata.range(70, parallelism=3)
    assert [len(b["id"]) for b in ds.iter_batches(batch_size=32, device="cpu")] \
        == [32, 32, 6]
    assert [len(b["id"]) for b in ds.iter_batches(
        batch_size=32, drop_last=True, device="cpu")] == [32, 32]
    assert [len(b["id"]) for b in ds.iter_batches(batch_size=70)] == [70]


def test_sharding_is_applied_before_the_copy():
    """`sharding` sees each host batch (numpy) and only its output is
    copied: here every other row."""
    seen = []

    def half(batch):
        seen.append({k: type(v) for k, v in batch.items()})
        return {k: v[::2] for k, v in batch.items()}

    out = list(table(tdata, 40).iter_batches(batch_size=10, device="cpu",
                                              sharding=half))
    assert all(t == np.ndarray for s in seen for t in s.values())
    want = np.arange(40).reshape(4, 10)[:, ::2]
    assert [b["id"].tolist() for b in out] == want.tolist()
    stacks = list(titer.iter_stacked_batches(
        table(tdata, 40).iter_block_refs(), batch_size=10, steps_per_stack=2,
        device="cpu", sharding=half))
    assert [s["id"].shape for s in stacks] == [(2, 5), (2, 5)]


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_the_prefetch_window(prefetch):
    """When batch N is yielded, the copies of N + 1 .. N + prefetch have
    been issued, and no more."""
    issued = []
    gen = titer._prefetched(iter(range(6)), lambda i: issued.append(i) or i,
                            max(1, prefetch + 1))
    for n in gen:
        assert issued[-1] == min(n + prefetch, 5)


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tdata.range(8).iter_batches(batch_size=4, device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(titer.iter_stacked_batches(
            tdata.range(8).iter_block_refs(), batch_size=2, steps_per_stack=2,
            device="cuda"))


def test_a_string_column_bound_for_a_device_raises():
    ds = tdata.from_items([{"id": i, "name": f"n{i}"} for i in range(4)])
    with pytest.raises(TypeError, match="column 'name'"):
        next(ds.iter_batches(batch_size=2, device="cpu"))
    # without a device the strings pass as numpy, as in the reference
    assert next(ds.iter_batches(batch_size=2))["name"].tolist() == ["n0", "n1"]


@pytest.mark.cuda
def test_pinned_copy_stream_on_the_card():
    """50 batches through the pinned copy-stream path, never synchronized
    by the loop: the consumer's stream, held back by a spin kernel, copies
    each batch and then writes into it in place. Each copy equals its
    numpy source in every bit (a staging buffer refilled before its copy
    completed, a consumer that did not wait for the copy, or device memory
    handed out again under the consumer's write, shows as a wrong batch);
    a fixed pool of staging buffers serves them all."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    src = rng.standard_normal((50 * 64, 1024)).astype(np.float32)
    # two columns of one shape and dtype: each needs its own buffer
    ds = tdata.from_numpy(np.array_split(src, 10)).map_batches(
        lambda b: {"data": b["data"], "neg": -b["data"]})
    allocs = []
    real_empty = torch.empty

    def counting_empty(*args, **kwargs):
        if kwargs.get("pin_memory"):
            allocs.append(args)
        return real_empty(*args, **kwargs)

    torch.empty = counting_empty
    copies = []
    try:
        for batch in ds.iter_batches(batch_size=64, device="cuda",
                                     prefetch_batches=2):
            x = batch["data"]
            assert x.device.type == "cuda"
            torch.cuda._sleep(2_000_000)      # the consumer lags the copies
            copies.append((x.clone(), batch["neg"].clone()))
            x.mul_(-1.0).add_(7.0)            # and writes in place
            del x, batch
    finally:
        torch.empty = real_empty
    torch.cuda.synchronize()
    assert len(copies) == 50
    for i, (got, neg) in enumerate(copies):
        assert np.array_equal(got.cpu().numpy(), src[i * 64:(i + 1) * 64]), i
        assert np.array_equal(neg.cpu().numpy(), -src[i * 64:(i + 1) * 64]), i
    assert len(allocs) <= 2 * 4, len(allocs)
