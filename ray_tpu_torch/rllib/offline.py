"""Offline RL IO: write experience to disk, read it back for training.

The port's copy of ray_tpu/rllib/offline.py: host numpy and files, no
device. It writes the reference's records (JSON-lines, one SampleBatch a
line, each column base64-encoded as dtype, shape and raw bytes), so a
file written by either package reads in the other to identical arrays.
What is read goes into a host-side ReplayBuffer (algorithms/bc.py); only
a sampled batch goes to the learner's device.

`to_dataset` hands the rows to the Data plane (`ray_tpu_torch.data`) as
a Dataset of flat rows.

Parity: rllib/offline/ (json_reader.py / json_writer.py / dataset_reader.py)
— the path that records rollouts and trains from logged data without an
environment.
"""

from __future__ import annotations

import base64
import glob
import json
import os
from typing import Iterator, List

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


def _encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {
        "dtype": a.dtype.str,
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode(),
    }


def _decode_array(d: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(d["data"]), dtype=d["dtype"]
    ).reshape(d["shape"])


class JsonWriter:
    """Append SampleBatches to rotating .jsonl files in a directory."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.max_file_size = max_file_size
        self._index = 0
        self._f = None

    def _file(self):
        if self._f is None or self._f.tell() > self.max_file_size:
            if self._f:
                self._f.close()
            name = os.path.join(
                self.path, f"batches-{os.getpid()}-{self._index:05d}.jsonl"
            )
            self._index += 1
            self._f = open(name, "a")
        return self._f

    def write(self, batch: SampleBatch) -> None:
        rec = {k: _encode_array(np.asarray(v)) for k, v in batch.items()}
        f = self._file()
        f.write(json.dumps(rec) + "\n")
        f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class JsonReader:
    """Iterate SampleBatches from a directory (or file, or glob) of .jsonl."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files = sorted(glob.glob(os.path.join(path, "*.jsonl")))
        else:
            self.files = sorted(glob.glob(path))
        if not self.files:
            raise FileNotFoundError(f"no .jsonl batch files under {path!r}")

    def __iter__(self) -> Iterator[SampleBatch]:
        for fname in self.files:
            with open(fname) as f:
                for line in f:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    yield SampleBatch(
                        {k: _decode_array(v) for k, v in rec.items()}
                    )

    def read_all(self) -> SampleBatch:
        return SampleBatch.concat_samples(list(self))


def to_dataset(path: str, parallelism: int = 4):
    """Load logged experience as a data.Dataset of flat rows — shuffled
    minibatch streaming for offline algorithms rides the Data layer."""
    from ray_tpu_torch import data as rd

    batch = JsonReader(path).read_all()
    rows: List[dict] = []
    n = len(batch)
    for i in range(n):
        rows.append({k: np.asarray(v)[i] for k, v in batch.items()})
    return rd.from_items(rows, parallelism=parallelism)
