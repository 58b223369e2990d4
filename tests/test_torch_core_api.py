"""Port vs reference: the runtime's in-process mode (ray_tpu_torch.api on
core/local_backend.py) against ray_tpu's local mode.

Every case of tests/test_core_api_local.py runs as a pair program: the same
function, given the package as `ray`, runs under ray_tpu.init(local_mode=
True) and under ray_tpu_torch.init(local_mode=True) (each shut down before
and after), and the two outcomes must be equal: the values, their order,
and the class name of an exception raised. The cases the port adds (GPU
options, tensors by reference, the refused modes, actor restarts, cancel)
follow. Inputs come from numpy with a seed.
"""

import os
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

PACKAGES = (ray_tpu, ray_tpu_torch)


def outcome(program, ray):
    """("value", program(ray)) or ("raised", the exception's class name)."""
    try:
        return ("value", program(ray))
    except Exception as e:  # noqa: BLE001 - compared by class name
        return ("raised", type(e).__name__)


def run_local(program, ray):
    ray.shutdown()
    ray.init(local_mode=True)
    try:
        return outcome(program, ray)
    finally:
        ray.shutdown()


@pytest.fixture
def both():
    """Runs a pair program under each package's local mode; returns the
    reference's outcome after checking the port's equals it."""
    def run(program):
        ref, port = (run_local(program, ray) for ray in PACKAGES)
        assert port == ref, (ref, port)
        return ref

    yield run
    for ray in PACKAGES:
        ray.shutdown()


@pytest.fixture
def ray_torch():
    """The port's local mode alone."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# ------------------------------------------------ tests/test_core_api_local.py

def test_task_roundtrip(both):
    def program(ray):
        @ray.remote
        def add(a, b):
            return a + b

        return ray.get(add.remote(1, 2))

    assert both(program) == ("value", 3)


def test_task_chaining_and_ref_args(both):
    def program(ray):
        @ray.remote
        def double(x):
            return 2 * x

        return ray.get(double.remote(double.remote(double.remote(1))))

    assert both(program) == ("value", 8)


def test_put_get_numpy_roundtrip(both):
    arr = np.random.default_rng(0).standard_normal((1000, 100)).astype(np.float32)

    def program(ray):
        out = ray.get(ray.put(arr))
        return out is arr, out.tolist() == arr.tolist()

    assert both(program) == ("value", (True, True))


def test_num_returns(both):
    def program(ray):
        @ray.remote(num_returns=3)
        def three():
            return 1, 2, 3

        return ray.get(list(three.remote()))

    assert both(program) == ("value", [1, 2, 3])


def test_num_returns_mismatch_raises(both):
    def program(ray):
        @ray.remote(num_returns=2)
        def one():
            return (1,)

        return ray.get(one.remote())

    assert both(program) == ("raised", "ValueError")


def test_options_override(both):
    def program(ray):
        @ray.remote
        def pair():
            return "x", "y"

        return ray.get(pair.options(num_returns=2).remote())

    assert both(program) == ("value", ["x", "y"])


def test_task_error_propagates(both):
    def program(ray):
        @ray.remote
        def boom():
            raise ValueError("kapow")

        try:
            ray.get(boom.remote())
        except ValueError as e:
            return type(e).__name__, str(e)

    assert both(program) == ("value", ("ValueError", "kapow"))


def test_wait(both):
    def program(ray):
        @ray.remote
        def fast():
            return "fast"

        @ray.remote
        def slow():
            time.sleep(2)
            return "slow"

        f, s = fast.remote(), slow.remote()
        ready, not_ready = ray.wait([f, s], num_returns=1, timeout=1.5)
        return ready == [f], not_ready == [s], ray.get(ready)

    assert both(program) == ("value", (True, True, ["fast"]))


def test_wait_refuses_duplicates_and_too_many(both):
    def program(ray):
        ref = ray.put(1)
        out = []
        for args in (([ref, ref], 1), ([ref], 2)):
            try:
                ray.wait(args[0], num_returns=args[1])
            except ValueError:
                out.append("ValueError")
        return out

    assert both(program) == ("value", ["ValueError", "ValueError"])


def test_get_timeout(both):
    def program(ray):
        @ray.remote
        def hang():
            time.sleep(2)

        return ray.get(hang.remote(), timeout=0.2)

    assert both(program) == ("raised", "GetTimeoutError")


def test_get_timeout_is_a_timeout_error(both):
    def program(ray):
        return (issubclass(ray.exceptions.GetTimeoutError, TimeoutError),
                [c.__name__ for c in ray.exceptions.ActorDiedError.__mro__[:4]])

    assert both(program) == ("value", (True, ["ActorDiedError", "ActorError",
                                              "RayTpuError", "Exception"]))


def test_actor_basics(both):
    def program(ray):
        @ray.remote
        class Counter:
            def __init__(self, start=0):
                self.n = start

            def incr(self, by=1):
                self.n += by
                return self.n

            def value(self):
                return self.n

        c = Counter.remote(10)
        refs = [c.incr.remote() for _ in range(5)]
        return ray.get(refs), ray.get(c.value.remote())

    assert both(program) == ("value", ([11, 12, 13, 14, 15], 15))


def test_actor_handle_passing(both):
    def program(ray):
        @ray.remote
        class Holder:
            def __init__(self):
                self.v = 7

            def value(self):
                return self.v

        @ray.remote
        def reader(h):
            return ray.get(h.value.remote())

        return ray.get(reader.remote(Holder.remote()))

    assert both(program) == ("value", 7)


def test_named_actor(both):
    def program(ray):
        @ray.remote
        class Svc:
            def ping(self):
                return "pong"

        creator = Svc.options(name="svc").remote()  # noqa: F841 - keep alive
        out = [ray.get(ray.get_actor("svc").ping.remote())]
        try:
            Svc.options(name="svc").remote()
        except ValueError:
            out.append("taken")
        same = Svc.options(name="svc", get_if_exists=True).remote()
        out.append(ray.get(same.ping.remote()))
        try:
            ray.get_actor("nobody")
        except ValueError:
            out.append("missing")
        return out

    assert both(program) == ("value", ["pong", "taken", "pong", "missing"])


def test_actor_error(both):
    def program(ray):
        @ray.remote
        class Bad:
            def fail(self):
                raise RuntimeError("actor oops")

            def ok(self):
                return "still alive"

        b = Bad.remote()
        try:
            ray.get(b.fail.remote())
        except RuntimeError as e:
            return str(e), ray.get(b.ok.remote())

    assert both(program) == ("value", ("actor oops", "still alive"))


def test_actor_init_error(both):
    def program(ray):
        @ray.remote
        class Broken:
            def __init__(self):
                raise KeyError("no")

            def ping(self):
                return 1

        b = Broken.remote()
        out = []
        for call in (lambda: backend_of(ray).wait_actor_alive(b._actor_id, 10),
                     lambda: ray.get(b.ping.remote())):
            try:
                call()
            except ray.exceptions.ActorDiedError as e:
                out.append("__init__ failed: KeyError" in str(e))
        return out

    assert both(program) == ("value", [True, True])


def test_nested_tasks(both):
    def program(ray):
        @ray.remote
        def leaf(x):
            return x * x

        @ray.remote
        def parent(n):
            return sum(ray.get([leaf.remote(i) for i in range(n)]))

        return ray.get(parent.remote(4))

    assert both(program) == ("value", 0 + 1 + 4 + 9)


def test_retry_exceptions(both):
    def program(ray):
        state = {"n": 0}

        @ray.remote(retry_exceptions=True, max_retries=3)
        def flaky():
            state["n"] += 1
            if state["n"] < 3:
                raise OSError("transient")
            return state["n"]

        return ray.get(flaky.remote())

    assert both(program) == ("value", 3)


def test_retries_exhausted_raise_the_last_error(both):
    def program(ray):
        state = {"n": 0}

        @ray.remote(retry_exceptions=True, max_retries=1)
        def always():
            state["n"] += 1
            raise OSError(f"attempt {state['n']}")

        try:
            ray.get(always.remote())
        except OSError as e:
            return str(e), state["n"]

    assert both(program) == ("value", ("attempt 2", 2))


def test_resource_set_arithmetic():
    from ray_tpu.core.resources import ResourceSet as RefSet
    from ray_tpu_torch.core.resources import ResourceSet

    for cls in (RefSet, ResourceSet):
        total = cls({"CPU": 4, "GPU": 8})
        demand = cls({"CPU": 1, "GPU": 2})
        assert total.fits(demand)
        rem = total.subtract(demand)
        assert rem.get("CPU") == 3 and rem.get("GPU") == 6
        assert not cls({"CPU": 0.5}).fits(cls({"CPU": 1}))
        # fixed-point: no float drift for fractional cpus
        r = cls({"CPU": 4})
        for _ in range(40):
            r = r.subtract(cls({"CPU": 0.1}))
        assert r.get("CPU") == 0.0
        assert total.add(demand).to_dict() == {"CPU": 5.0, "GPU": 10.0}
        assert rem.utilization(total) == pytest.approx(0.25)


# ---------------------------------------------------------- beyond that file

def backend_of(ray):
    import importlib

    return importlib.import_module(ray.__name__ + ".api")._global_worker().backend


def test_put_many_and_create_deferred(both):
    def program(ray):
        refs = ray.put_many([1, "a", None])
        ref, fulfill = backend_of(ray).create_deferred()
        fulfill(value=5)
        bad, fulfill_bad = backend_of(ray).create_deferred()
        fulfill_bad(error=KeyError("k"))
        out = [ray.get(refs), ray.get(ref)]
        try:
            ray.get(bad)
        except KeyError:
            out.append("KeyError")
        return out

    assert both(program) == ("value", [[1, "a", None], 5, "KeyError"])


def test_actor_max_concurrency_runs_calls_together(both):
    def program(ray):
        import threading

        @ray.remote(max_concurrency=2)
        class Gate:
            def __init__(self):
                self.barrier = threading.Barrier(2, timeout=10)

            def meet(self, i):
                self.barrier.wait()
                return i

        g = Gate.remote()
        return ray.get([g.meet.remote(0), g.meet.remote(1)], timeout=20)

    assert both(program) == ("value", [0, 1])


def test_actor_state_and_listeners(both):
    def program(ray):
        backend = backend_of(ray)
        events = []
        backend.add_actor_listener(lambda aid, state, reason: events.append(state))

        @ray.remote
        class A:
            def ping(self):
                return 1

        a = A.remote()
        backend.wait_actor_alive(a._actor_id, 10)
        states = [backend.actor_state(a._actor_id)]
        ray.kill(a)
        states.append(backend.actor_state(a._actor_id))
        try:
            backend.wait_actor_alive(a._actor_id, 1)
        except ray.exceptions.ActorDiedError:
            states.append("ActorDiedError")
        return states, events

    assert both(program) == ("value", (["ALIVE", "DEAD", "ActorDiedError"], ["DEAD"]))


def test_cluster_resources_and_nodes(both):
    def program(ray):
        res = ray.cluster_resources()
        nodes = ray.nodes()
        return (res["CPU"], res["memory"] > 0, res == ray.available_resources(),
                len(nodes), nodes[0]["Alive"])

    assert both(program) == ("value", (float(os.cpu_count()), True, True, 1, True))


def test_a_cpu_tensor_is_put_and_got_by_reference(both):
    t = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 64)))

    def program(ray):
        @ray.remote
        def same(x):
            return x

        return ray.get(ray.put(t)) is t, ray.get(same.remote(ray.put(t))) is t

    assert both(program) == ("value", (True, True))


def test_kill_without_no_restart_still_kills_in_local_mode(both):
    """Both packages' local mode end the actor for good whatever
    no_restart says (ROADMAP Queue C)."""
    def program(ray):
        @ray.remote(max_restarts=1)
        class A:
            def ping(self):
                return 1

        a = A.remote()
        ray.get(a.ping.remote())
        ray.kill(a, no_restart=False)
        return ray.get(a.ping.remote())

    assert both(program) == ("raised", "ActorDiedError")


def test_actor_restarts_after_a_worker_death(both):
    """max_restarts=1: the first simulated worker death restarts the actor
    with fresh state, pending calls fail; the second ends it."""
    def program(ray):
        backend = backend_of(ray)

        @ray.remote(max_restarts=1)
        class A:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        a = A.remote()
        out = [ray.get([a.incr.remote(), a.incr.remote()])]
        out.append(backend._fail_actor(a._actor_id, "worker died"))
        backend.wait_actor_alive(a._actor_id, 10)
        out.append(ray.get(a.incr.remote()))
        out.append(backend._fail_actor(a._actor_id, "worker died again"))
        out.append(backend.actor_state(a._actor_id))
        try:
            ray.get(a.incr.remote())
        except ray.exceptions.ActorDiedError:
            out.append("ActorDiedError")
        return out

    assert both(program) == ("value", [[1, 2], True, 1, True, "DEAD", "ActorDiedError"])


def test_cancel_before_a_retry(both):
    """cancel marks the task; a task between attempts stops with
    TaskCancelledError instead of retrying."""
    def program(ray):
        @ray.remote(retry_exceptions=True, max_retries=3)
        def flaky():
            raise OSError("transient")

        ref = flaky.remote()
        ray.cancel(ref)
        return ray.get(ref, timeout=30)

    assert both(program) == ("raised", "TaskCancelledError")


def test_num_gpus_accepted_and_num_tpus_refused(ray_torch):
    @ray_torch.remote(num_gpus=1)
    def on_gpu():
        return "ran"

    assert ray_torch.get(on_gpu.remote()) == "ran"
    assert on_gpu.options(num_gpus=2)._default_options.task_resources() == {
        "CPU": 1.0, "GPU": 2.0}
    with pytest.raises(ValueError, match="num_gpus"):
        ray_torch.remote(num_tpus=1)(lambda: 1)
    with pytest.raises(ValueError, match="num_gpus"):
        on_gpu.options(num_tpus=1)
    # the reference the other way round
    with pytest.raises(ValueError, match="num_tpus"):
        ray_tpu.remote(num_gpus=1)(lambda: 1)
    assert ray_tpu.remote(num_tpus=1)(lambda: 1)._default_options.task_resources() == {
        "CPU": 1.0, "TPU": 1.0}


def test_gpu_resources_follow_torch_cuda(ray_torch):
    """GPU and GPU-<kind> = the visible cards; none, and CUDA left
    uninitialised, where torch.cuda.is_available() is false (here)."""
    from ray_tpu_torch.core.resources import detect_gpu_resources, node_resources

    assert node_resources(num_cpus=2, num_gpus=4, memory_mb=10) == {
        "CPU": 2.0, "GPU": 4.0, "memory": 10.0}
    res = ray_torch.cluster_resources()
    if torch.cuda.is_available():
        n = float(torch.cuda.device_count())
        kind = torch.cuda.get_device_name(0).lower().replace(" ", "-")
        assert res["GPU"] == res[f"GPU-{kind}"] == n
    else:
        assert detect_gpu_resources() == {} and "GPU" not in res
        assert not torch.cuda.is_initialized()


@pytest.mark.cuda
def test_gpu_resources_open_no_cuda_context():
    """On a card: a fresh process that asks for the cluster's resources
    sees GPU and GPU-<kind> (the kind torch names) and has not
    initialised CUDA."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    code = (
        "import torch, ray_tpu_torch as r\n"
        "r.init(local_mode=True)\n"
        "res = r.cluster_resources()\n"
        "assert not torch.cuda.is_initialized()\n"
        "kind = torch.cuda.get_device_name(0).lower().replace(' ', '-')\n"
        "assert res['GPU'] == res['GPU-' + kind] == torch.cuda.device_count(), res\n"
        "r.shutdown()\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_init_without_local_mode_raises(monkeypatch):
    ray_tpu_torch.shutdown()
    monkeypatch.delenv("RAY_TPU_LOCAL_MODE", raising=False)
    for kwargs in ({}, {"address": "localhost:6379"}, {"address": "ray://h:1"},
                   {"address": "ray://h:1", "local_mode": True}):
        with pytest.raises(NotImplementedError, match="multi-process runtime"):
            ray_tpu_torch.init(**kwargs)
        assert not ray_tpu_torch.is_initialized()

    @ray_tpu_torch.remote
    def f():
        return 1

    with pytest.raises(NotImplementedError):
        f.remote()      # auto-init takes the same path
    monkeypatch.setenv("RAY_TPU_LOCAL_MODE", "1")
    ray_tpu_torch.init()
    try:
        assert ray_tpu_torch.get(f.remote()) == 1
        with pytest.raises(RuntimeError, match="twice"):
            ray_tpu_torch.init()
        ray_tpu_torch.init(ignore_reinit_error=True)
    finally:
        ray_tpu_torch.shutdown()


def test_streaming_and_bind_are_refused(ray_torch):
    @ray_torch.remote(num_returns="streaming")
    def gen():
        yield 1

    with pytest.raises(NotImplementedError, match="streaming"):
        gen.remote()

    @ray_torch.remote
    class A:
        @ray_torch.method(num_returns="streaming")
        def items(self):
            yield 1

        def ping(self):
            return 1

    a = A.remote()
    with pytest.raises(NotImplementedError, match="streaming"):
        a.items.remote()
    for bind in (gen.bind, A.bind, a.ping.bind):
        with pytest.raises(NotImplementedError, match="cgraph"):
            bind()
    assert ray_torch.get(a.ping.remote()) == 1


def test_remote_objects_cannot_be_called_directly(both):
    def program(ray):
        @ray.remote
        def f():
            return 1

        @ray.remote
        class A:
            def m(self):
                return 1

        out = []
        for call in (f, A, A.remote().m):
            try:
                call()
            except TypeError:
                out.append("TypeError")
        try:
            ray.put(ray.put(1))
        except TypeError:
            out.append("TypeError")
        return out

    assert both(program) == ("value", ["TypeError"] * 4)


@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_retry_delays_follow_the_reference_backoff(monkeypatch, jitter):
    """The local backend's retry delays: the reference BackoffPolicy's
    exponential rule from the same config fields, capped at the max, and
    within ± jitter of it."""
    from ray_tpu.core.config import _config as ref_config
    from ray_tpu.util.backoff import BackoffPolicy
    from ray_tpu_torch.core.config import _config
    from ray_tpu_torch.util import backoff

    for cfg in (ref_config, _config):
        monkeypatch.setattr(cfg, "retry_backoff_jitter", jitter)
    for attempt in range(1, 14):
        want = BackoffPolicy(jitter=0.0).delay(attempt)
        got = backoff.delay(attempt)
        assert want * (1 - jitter) <= got <= want * (1 + jitter)
        if not jitter:
            assert got == pytest.approx(want, rel=1e-12)
    assert backoff.delay(30) <= _config.retry_backoff_max_ms / 1000.0 * (1 + jitter)
