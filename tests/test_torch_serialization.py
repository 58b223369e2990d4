"""Port vs reference: serialization (ray_tpu_torch/core/serialization.py
against ray_tpu/core/serialization.py).

The cases of tests/test_serialization.py that need no cluster run through
both packages' modules (parametrized by `ser`), then the port's own: torch
tensors out of band, byte for byte, and numpy arrays deserializing equal
with the same buffers in both. Inputs come from numpy with a seed.
"""

import sys

import numpy as np
import pytest
import torch

from ray_tpu.core import serialization as ref_ser
from ray_tpu_torch.core import serialization as port_ser

MODULE_CONSTANT = 41


def module_level_fn(x):
    return x + MODULE_CONSTANT


class ModuleLevelClass:
    def __init__(self, x):
        self.x = x

    def double(self):
        return self.x * 2


@pytest.fixture(params=["ray_tpu", "ray_tpu_torch"])
def ser(request):
    return {"ray_tpu": ref_ser, "ray_tpu_torch": port_ser}[request.param]


def roundtrip(ser, value):
    return ser.loads(ser.dumps(value))


class without_this_module:
    """Deserialize with this test module gone from sys.modules: a payload
    that needs it (by reference) fails, a by-value one does not."""

    def __enter__(self):
        self.mod = sys.modules.pop(__name__)

    def __exit__(self, *exc):
        sys.modules[__name__] = self.mod


# ------------------------------------------ tests/test_serialization.py:36-136

def test_roundtrip_basic_values(ser):
    for v in [1, "a", None, {"k": [1, 2.5, b"bytes"]}, (1, 2), {3, 4}]:
        assert roundtrip(ser, v) == v


def test_roundtrip_numpy_zero_copy_oob(ser):
    arr = np.arange(100_000, dtype=np.float32).reshape(100, 1000)
    s = ser.serialize(arr)
    assert s.buffers, "large ndarray should be an out-of-band buffer"
    assert len(s.payload) < 10_000
    np.testing.assert_array_equal(ser.deserialize(s), arr)


def test_roundtrip_local_closure(ser):
    y = 10

    def local_fn(x):
        return x + y

    assert roundtrip(ser, local_fn)(5) == 15


def test_roundtrip_lambda(ser):
    assert roundtrip(ser, lambda x: x * 3)(4) == 12


def test_module_function_pickled_by_value(ser):
    assert ser.deserialize(ser.serialize(module_level_fn))(1) == 42
    blob = ser.dumps(module_level_fn)
    with without_this_module():
        assert ser.loads(blob)(2) == 43


def test_module_class_pickled_by_value(ser):
    blob = ser.dumps(ModuleLevelClass)
    with without_this_module():
        assert ser.loads(blob)(21).double() == 42


def test_module_class_instance_pickled_by_value(ser):
    blob = ser.dumps(ModuleLevelClass(7))
    with without_this_module():
        assert ser.loads(blob).double() == 14


def test_installed_packages_pickle_by_reference(ser):
    import cloudpickle

    assert len(ser.dumps(np.mean)) < 2000, "np.mean should pickle as a reference"
    assert not getattr(cloudpickle.cloudpickle, "_PICKLE_BY_VALUE_MODULES", {}), (
        "serialize leaked by-value module registrations")


def test_nested_function_in_container(ser):
    blob = ser.dumps({"cb": module_level_fn, "data": [1, 2]})
    with without_this_module():
        out = ser.loads(blob)
        assert out["cb"](0) == 41
        assert out["data"] == [1, 2]


def test_serialization_oob_buffers(ser):
    """tests/test_core_api_local.py::test_serialization_oob_buffers."""
    arr = np.random.default_rng(0).random((512, 512))
    out = roundtrip(ser, {"a": arr, "b": [1, "x"]})
    np.testing.assert_array_equal(out["a"], arr)
    assert out["b"] == [1, "x"]


def test_contained_refs_are_collected(ser):
    refs_mod = sys.modules[ser.__name__.replace("serialization", "refs")]
    ids_mod = sys.modules[ser.__name__.replace("serialization", "ids")]
    ref = refs_mod.ObjectRef(ids_mod.ObjectID.from_random())
    s = ser.serialize({"r": [ref]})
    assert s.contained_refs == [ref]
    assert ser.deserialize(s)["r"][0] == ref


# ------------------------------------------------------- numpy in both packages

@pytest.mark.parametrize("shape,dtype", [((300, 400), np.float32),
                                         ((4, 8), np.float64),
                                         ((64, 1024, 2), np.int64),
                                         ((100_000,), np.bool_)])
def test_numpy_arrays_deserialize_equal_in_both_packages(shape, dtype):
    arr = np.random.default_rng(2).standard_normal(shape).astype(dtype)
    a, b = ref_ser.serialize(arr), port_ser.serialize(arr)
    assert [m.nbytes for m in a.buffers] == [m.nbytes for m in b.buffers]
    assert len(a.buffers) == (arr.nbytes >= 1 << 16)
    for out in (ref_ser.deserialize(a), port_ser.deserialize(b),
                port_ser.loads(port_ser.dumps(arr))):
        assert out.dtype == arr.dtype and out.shape == arr.shape
        np.testing.assert_array_equal(out, arr)


# ---------------------------------------------------------------- torch tensors

def tensor(shape, dtype, seed=3):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))
    return x.to(dtype)


def same_bytes(a, b):
    """Equal dtype, shape and bytes (NaN-safe, bf16 included)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(-1).view(torch.uint8),
                            b.contiguous().view(-1).view(torch.uint8)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64,
                                   torch.float16])
def test_cpu_tensor_travels_as_one_out_of_band_buffer(dtype):
    t = tensor((256, 300), dtype)
    s = port_ser.serialize(t)
    assert [b.nbytes for b in s.buffers] == [t.numel() * t.element_size()]
    assert len(s.payload) < 1000
    out = port_ser.deserialize(s)
    assert same_bytes(out, t) and out.stride() == t.stride()
    # dumps/loads: the flattened frame, read back from immutable bytes
    assert same_bytes(port_ser.loads(port_ser.dumps(t)), t)


@pytest.mark.parametrize("view", ["transposed", "strided", "sliced", "expanded"])
def test_non_contiguous_tensor_keeps_shape_strides_and_values(view):
    base = tensor((128, 256), torch.float32)
    t = {"transposed": base.t(), "strided": base[:, ::2],
         "sliced": base[3:100, 10:200],
         "expanded": base[:1].expand(64, 256)}[view]
    s = port_ser.serialize(t)
    out = port_ser.deserialize(s)
    assert out.shape == t.shape and out.stride() == t.stride()
    assert torch.equal(out, t)
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    assert sum(b.nbytes for b in s.buffers) in (0, span * 4)


def test_small_and_empty_tensors_stay_in_band():
    for t in (tensor((4, 5), torch.bfloat16), torch.tensor(3.5),
              torch.zeros(0, 7, dtype=torch.int32)):
        s = port_ser.serialize(t)
        assert not s.buffers
        out = port_ser.deserialize(s)
        assert same_bytes(out, t) and out.shape == t.shape


def test_tensor_in_a_container_keeps_a_leaf_requires_grad():
    w = tensor((200, 200), torch.float32).requires_grad_(True)
    tree = {"w": w, "step": 3, "xs": [tensor((400, 100), torch.bfloat16)],
            "y": w * 2}
    s = port_ser.serialize(tree)
    assert len(s.buffers) == 3
    out = port_ser.deserialize(s)
    assert out["step"] == 3 and out["w"].requires_grad and out["w"].is_leaf
    # a non-leaf travels detached: autograd's graph does not cross
    assert not out["y"].requires_grad and not out["xs"][0].requires_grad
    assert same_bytes(out["w"], w.detach()) and same_bytes(out["xs"][0], tree["xs"][0])
    assert same_bytes(out["y"], (w * 2).detach())


@pytest.mark.parametrize("requires_grad", [True, False])
def test_parameter_comes_back_a_parameter(requires_grad):
    p = torch.nn.Parameter(tensor((150, 150), torch.float32),
                           requires_grad=requires_grad)
    out = port_ser.loads(port_ser.dumps({"p": p}))["p"]
    assert type(out) is torch.nn.Parameter
    assert out.requires_grad == requires_grad
    assert same_bytes(out, p.detach())


def test_module_round_trip_still_trains():
    torch.manual_seed(0)
    lin = torch.nn.Linear(300, 200)
    out = port_ser.loads(port_ser.dumps(lin))
    assert all(type(q) is torch.nn.Parameter and q.requires_grad
               for q in out.parameters())
    for a, b in zip(lin.parameters(), out.parameters()):
        assert same_bytes(a.detach(), b.detach())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 300)).astype(np.float32))
    opt = torch.optim.SGD(out.parameters(), lr=0.1)
    before = out.weight.detach().clone()
    out(x).square().sum().backward()
    opt.step()
    assert out.weight.grad is not None and not torch.equal(out.weight, before)


def test_device_get_leaves_a_cpu_tensor_as_it_is():
    t = tensor((8, 8), torch.float32)
    assert port_ser._device_get_if_torch(t) is t
    assert port_ser._device_get_if_torch([t])[0] is t
    arr = np.ones(3)
    assert port_ser._device_get_if_torch(arr) is arr


def test_cpu_tensors_leave_cuda_uninitialised():
    port_ser.loads(port_ser.dumps(tensor((300, 300), torch.float32)))
    assert not torch.cuda.is_initialized()
