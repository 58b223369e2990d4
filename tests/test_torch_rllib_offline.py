"""Port vs JAX package on the CPU: offline experience IO
(ray_tpu_torch.rllib.offline against ray_tpu.rllib.offline). The
reference's round trip on the port; files written by either package read
in the other to identical arrays (dtypes and shapes too), and the two
write the same records; a missing path raises FileNotFoundError;
to_dataset, which stands on the Data plane, is refused.
"""

import json

import numpy as np
import pytest

from ray_tpu.rllib import offline as joffline
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch.rllib import offline
from ray_tpu_torch.rllib.offline import JsonReader, JsonWriter, to_dataset
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _batch(n, seed=0, cls=SampleBatch):
    rng = np.random.default_rng(seed)
    return cls({
        SampleBatch.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, n),
        SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
        SampleBatch.TERMINATEDS: rng.random(n) < 0.3,
        SampleBatch.EPS_ID: rng.integers(0, 2**40, n),
        "weights": rng.random(n),  # float64
    })


def test_json_roundtrip(tmp_path):
    w = JsonWriter(str(tmp_path))
    b1, b2 = _batch(16, 0), _batch(8, 1)
    w.write(b1)
    w.write(b2)
    w.close()

    r = JsonReader(str(tmp_path))
    batches = list(r)
    assert [len(b) for b in batches] == [16, 8]
    np.testing.assert_array_equal(
        batches[0][SampleBatch.OBS], b1[SampleBatch.OBS]
    )
    allb = r.read_all()
    assert len(allb) == 24

    with pytest.raises(FileNotFoundError):
        JsonReader(str(tmp_path / "missing"))


def same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_files_cross_between_the_packages(tmp_path, direction):
    writer, reader, cls = {
        "reference_to_port": (joffline.JsonWriter, JsonReader, JSampleBatch),
        "port_to_reference": (JsonWriter, joffline.JsonReader, SampleBatch),
    }[direction]
    batches = [_batch(n, seed=n, cls=cls) for n in (5, 17, 1)]
    # a small rotation size: several files, read back in order
    w = writer(str(tmp_path), max_file_size=2_000)
    for b in batches:
        w.write(b)
    w.close()
    assert len(list(tmp_path.glob("*.jsonl"))) > 1
    same_batches(list(reader(str(tmp_path))), batches)
    same_batches([reader(str(tmp_path / "*.jsonl")).read_all()],
                 [SampleBatch.concat_samples([SampleBatch(b) for b in batches])])


def test_the_records_are_the_references(tmp_path):
    b = _batch(6, seed=2)
    for name, module in (("port", offline), ("ref", joffline)):
        w = module.JsonWriter(str(tmp_path / name))
        w.write(b)
        w.close()
    (mine,), (theirs,) = (list((tmp_path / n).glob("*.jsonl")) for n in ("port", "ref"))
    assert mine.name == theirs.name
    assert json.loads(mine.read_text()) == json.loads(theirs.read_text())
    for k, v in b.items():
        assert offline._encode_array(v) == joffline._encode_array(v)
        assert np.array_equal(offline._decode_array(joffline._encode_array(v)), v)


def test_to_dataset_waits_for_the_data_plane(tmp_path):
    w = JsonWriter(str(tmp_path))
    w.write(_batch(4))
    w.close()
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        to_dataset(str(tmp_path), parallelism=2)
