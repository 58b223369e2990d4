"""Port vs reference: the Data layer (ray_tpu_torch.data against
ray_tpu.data), each package under its own in-process runtime.

Every behaviour of tests/test_data.py runs as a pair program: the same
function, given the package's data module, runs through ray_tpu.data and
through ray_tpu_torch.data on the same inputs (made with numpy from a
seed), and the results must be equal: rows in order where the order is
defined (sources, per-block transforms, union, repartition, limit,
random_shuffle with a seed, sort, split), as sorted rows elsewhere
(map_groups), values with their dtypes. The cases: blocks; range, items
and numpy sources; map_batches, map, filter, flat_map, union,
repartition, limit; random_shuffle(seed), which gives the same
permutation; sort, groupby's aggregates and map_groups; the
preprocessors' fitted statistics and outputs; split's shards; stats()'s
operator names; parquet, csv and json files through tmp_path.
"""

import re

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu_torch
import ray_tpu_torch.data as tdata
from ray_tpu.data import block as jblock
from ray_tpu.data import executor as jexecutor
from ray_tpu.data import preprocessors as jpre
from ray_tpu_torch.data import block as tblock
from ray_tpu_torch.data import executor as texecutor
from ray_tpu_torch.data import preprocessors as tpre

# (runtime, data module, block module, preprocessors, executor) per package
PACKAGES = (
    (ray_tpu, jdata, jblock, jpre, jexecutor),
    (ray_tpu_torch, tdata, tblock, tpre, texecutor),
)


def plain(x):
    """Rows, blocks and values as plain Python with their dtypes: arrays
    become (dtype, nested list), numpy scalars (dtype, value)."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return (np.asarray(x).dtype.str, np.asarray(x).tolist())
    return x


@pytest.fixture(scope="module")
def both():
    """Runs program(pkg) for each package (pkg: a namespace with `ray`,
    `rd`, `block`, `pre`, `executor`) under its in-process runtime and
    returns the reference's result after checking the port's equals it."""
    for ray, *_ in PACKAGES:
        ray.shutdown()
        ray.init(local_mode=True)

    class Pkg:
        def __init__(self, ray, rd, block, pre, executor):
            self.ray, self.rd, self.block = ray, rd, block
            self.pre, self.executor = pre, executor

    def run(program):
        ref, port = (plain(program(Pkg(*p))) for p in PACKAGES)
        assert port == ref, (ref, port)
        return ref

    yield run
    for ray, *_ in PACKAGES:
        ray.shutdown()


def seeded_rows(n=48, seed=0):
    rng = np.random.default_rng(seed)
    return [{"k": int(k), "v": float(v), "s": f"s{int(i) % 5}"}
            for i, (k, v) in enumerate(zip(rng.integers(0, 4, n),
                                           rng.standard_normal(n)))]


# ---------------------------------------------------------------- blocks
BLOCK_CASES = {
    "from_dict_rows": lambda b: b.block_from_rows(seeded_rows(5)),
    "from_scalar_rows": lambda b: b.block_from_rows([10, 20, 30]),
    "from_no_rows": lambda b: b.block_from_rows([]),
    "concat_slice": lambda b: b.block_slice(b.block_concat(
        [{"x": np.arange(3)}, {}, {"x": np.arange(3, 7)}]), 2, 5),
    "take": lambda b: b.block_take(
        {"x": np.arange(10.0), "y": np.arange(10) % 3},
        np.random.default_rng(1).permutation(10)),
    "metadata": lambda b: vars(b.block_metadata(
        {"x": np.ones((4, 3), np.float32), "y": np.arange(4)})),
    "rows": lambda b: list(b.block_rows({"x": np.arange(3), "y": np.ones(3)})),
    "item_rows": lambda b: list(b.block_rows({"item": np.arange(3)})),
    "normalize_dict": lambda b: b.normalize_batch({"x": [1, 2], "y": (3.0, 4.0)}),
    "normalize_array": lambda b: b.normalize_batch(np.arange(4).reshape(2, 2)),
    "normalize_rows": lambda b: b.normalize_batch([{"a": 1}, {"a": 2}]),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_blocks(case):
    ref, port = (plain(BLOCK_CASES[case](b)) for b in (jblock, tblock))
    assert port == ref


def test_normalize_batch_refuses_other_types():
    for b in (jblock, tblock):
        with pytest.raises(TypeError, match="map_batches fn must return"):
            b.normalize_batch(3)


# ---------------------------------------------------------------- sources
SOURCES = {
    "range": lambda rd: rd.range(103, parallelism=5),
    "range_small": lambda rd: rd.range(5, parallelism=8),
    "items": lambda rd: rd.from_items(seeded_rows(), parallelism=4),
    "scalar_items": lambda rd: rd.from_items(
        np.random.default_rng(2).integers(0, 100, 30).tolist(), parallelism=3),
    "numpy": lambda rd: rd.from_numpy(
        np.random.default_rng(3).standard_normal((7, 3)).astype(np.float32)),
    "numpy_list": lambda rd: rd.from_numpy(
        [np.arange(6).reshape(3, 2), np.arange(6, 10).reshape(2, 2)], column="x"),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_sources(both, source):
    def program(p):
        ds = SOURCES[source](p.rd)
        return {"count": ds.count(), "take": ds.take(5), "all": ds.take_all(),
                "schema": ds.schema(), "blocks": len(list(ds.iter_block_refs()))}

    both(program)


# ---------------------------------------------------------------- transforms
def _stamp_size(b):
    n = len(next(iter(b.values())))
    return {"id": b["id"], "bs": np.full(n, n)}


TRANSFORMS = {
    "map_batches": lambda rd: rd.range(64, parallelism=4).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2}),
    "map_batches_batch_size": lambda rd: rd.range(100, parallelism=3)
    .map_batches(_stamp_size, batch_size=32),
    "map": lambda rd: rd.from_items(seeded_rows(), parallelism=4).map(
        lambda r: {"k": r["k"] * 10, "v": r["v"] + 1.0}),
    "filter": lambda rd: rd.range(50, parallelism=4)
    .map_batches(lambda b: {"id": b["id"] * 2})
    .filter(lambda r: r["id"] % 4 == 0),
    "flat_map": lambda rd: rd.from_items([1, 2, 3]).flat_map(
        lambda r: [int(r)] * int(r)),
    "union": lambda rd: rd.from_items([1, 2]).union(
        rd.from_items([3, 4]), rd.range(3)),
    "repartition": lambda rd: rd.range(10, parallelism=5).repartition(2),
    "repartition_up": lambda rd: rd.from_items(seeded_rows(23), parallelism=2)
    .repartition(5),
    "limit": lambda rd: rd.range(1000, parallelism=8).limit(17),
    "limit_after_map": lambda rd: rd.from_items(seeded_rows(), parallelism=4)
    .map_batches(lambda b: {"v": b["v"] * 2}).limit(13),
    "map_after_union": lambda rd: rd.from_items([3, 1]).union(
        rd.from_items([2, 4])).map(lambda r: int(r) * 10),
}


@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
def test_transforms(both, transform):
    def program(p):
        ds = TRANSFORMS[transform](p.rd)
        refs = list(ds.iter_block_refs())
        return {"rows": ds.take_all(), "count": ds.count(),
                "block_rows": [len(next(iter(p.ray.get(r).values()), []))
                               for r in refs]}

    both(program)


def test_actor_pool_map(both):
    """A callable class on an actor pool (local mode's actors)."""
    def program(p):
        class AddConst:
            def __init__(self, c):
                self.c = c

            def __call__(self, block):
                return {"id": block["id"] + self.c}

        ds = p.rd.range(40, parallelism=4).map_batches(
            AddConst, fn_args=(1000,),
            compute=p.executor.ActorPoolStrategy(size=2))
        return ds.take_all()

    both(program)


def test_actor_pool_stage_does_not_clobber_executor_cap(both):
    """tests/test_data.py's case: the pool's cap bounds its own stage only."""
    def program(p):
        ex = p.executor.StreamingExecutor(max_tasks_in_flight=8)
        ops = [
            p.executor.ReadOp([(lambda i=i: {"id": np.array([i])})
                               for i in range(6)]),
            p.executor.MapBatchesOp(
                fn=lambda b: {"id": b["id"] + 100},
                compute=p.executor.ActorPoolStrategy(
                    size=1, max_tasks_in_flight_per_actor=1)),
            p.executor.MapBatchesOp(fn=lambda b: {"id": b["id"] * 2}),
        ]
        caps, out = [], []
        for ref in ex.execute(ops):
            caps.append(ex.max_in_flight)
            out.append(int(p.ray.get(ref)["id"][0]))
        return {"out": out, "caps": caps}

    assert both(program)["caps"] == [8] * 6


# ---------------------------------------------------------------- shuffles
@pytest.mark.parametrize("seed,partitions", [(0, None), (3, None), (7, 3),
                                             (None, 2)])
def test_random_shuffle_gives_the_same_permutation(both, seed, partitions):
    def program(p):
        ds = p.rd.range(200, parallelism=4).random_shuffle(
            seed=seed, num_partitions=partitions)
        return [int(r["id"]) for r in ds.take_all()]

    rows = both(program)
    assert sorted(rows) == list(range(200)) and rows != list(range(200))


@pytest.mark.parametrize("key,descending,partitions", [
    ("v", False, None), ("v", True, None), ("k", False, 3), ("s", True, 2)])
def test_sort(both, key, descending, partitions):
    def program(p):
        ds = p.rd.from_items(seeded_rows(), parallelism=4)
        out = ds.sort(key, descending=descending, num_partitions=partitions)
        return {"rows": out.take_all(),
                "blocks": len(list(out.iter_block_refs()))}

    rows = both(program)["rows"]
    keys = [r[key][1] for r in rows]
    assert keys == sorted(keys, reverse=descending)


@pytest.mark.parametrize("agg", ["count", "sum", "mean", "min", "max"])
@pytest.mark.parametrize("key", ["k", "s"])
def test_groupby_aggregates(both, key, agg):
    def program(p):
        g = p.rd.from_items(seeded_rows(), parallelism=4).groupby(key)
        out = g.count() if agg == "count" else getattr(g, agg)("v")
        return sorted(out.items())

    both(program)


@pytest.mark.parametrize("key,partitions", [("k", 3), ("s", 4), ("k", None)])
def test_map_groups(both, key, partitions):
    def program(p):
        def spread(group):
            vs = np.asarray(group["v"])
            return {key: group[key][:1], "n": np.asarray([len(vs)]),
                    "spread": np.asarray([vs.max() - vs.min()])}

        ds = p.rd.from_items(seeded_rows(100), parallelism=8)
        out = ds.groupby(key).map_groups(spread, num_partitions=partitions)
        return sorted((r[key].item(), int(r["n"]), float(r["spread"]))
                      for r in out.take_all())

    both(program)


# ---------------------------------------------------------------- preprocessors
def _pre_rows():
    rng = np.random.default_rng(4)
    return [{"x": float(v), "y": float(i % 4), "label": ["a", "b", "c"][i % 3]}
            for i, v in enumerate(rng.normal(3.0, 2.0, 64))]


PREPROCESSORS = {
    "standard": lambda pre: pre.StandardScaler(["x", "y"]),
    "minmax": lambda pre: pre.MinMaxScaler(["y"]),
    "label": lambda pre: pre.LabelEncoder("label"),
    "batch_mapper": lambda pre: pre.BatchMapper(
        lambda b: {**b, "x": np.asarray(b["x"]) * 2.0}),
    "chain": lambda pre: pre.Chain(
        pre.StandardScaler(["x"]),
        pre.BatchMapper(lambda b: {**b, "x": np.asarray(b["x"]) * 2.0}),
        pre.MinMaxScaler(["x"])),
}


@pytest.mark.parametrize("name", sorted(PREPROCESSORS))
def test_preprocessors(both, name):
    """The fitted statistics and the transformed rows."""
    def program(p):
        ds = p.rd.from_items(_pre_rows(), parallelism=4)
        pp = PREPROCESSORS[name](p.pre)
        out = pp.fit_transform(ds).take_all()
        stages = pp.preprocessors if name == "chain" else [pp]
        fitted = [{k: v for k, v in vars(s).items()
                   if k.endswith("_") and not k.startswith("_")}
                  for s in stages]
        return {"rows": out, "fitted": fitted}

    both(program)


def test_preprocessor_must_be_fit(both):
    def program(p):
        try:
            p.pre.StandardScaler(["x"]).transform(p.rd.from_items(_pre_rows()))
        except RuntimeError as e:
            return str(e)

    assert "must be fit" in both(program)


def test_label_encoder_refuses_unseen_labels(both):
    def program(p):
        le = p.pre.LabelEncoder("label").fit(p.rd.from_items(_pre_rows()[:2]))
        try:
            le.transform(p.rd.from_items(_pre_rows())).take_all()
        except ValueError as e:
            return str(e)

    assert "not seen at fit" in both(program)


# ---------------------------------------------------------------- split
@pytest.mark.parametrize("rows,parallelism,n", [(103, 5, 4), (64, 4, 2),
                                                (10, 3, 1), (7, 2, 3)])
def test_split_shards(both, rows, parallelism, n):
    def program(p):
        shards = p.rd.range(rows, parallelism=parallelism).split(n)
        return [s.take_all() for s in shards]

    shards = both(program)
    counts = [len(s) for s in shards]
    assert sum(counts) == rows and max(counts) - min(counts) <= n - 1


# ---------------------------------------------------------------- stats
def test_stats_operator_names(both):
    def program(p):
        ds = (p.rd.range(100, parallelism=4).map_batches(lambda b: b)
              .limit(60))
        before = ds.stats()
        ds.take_all()
        lines = ds.stats().splitlines()[1:]
        return {"before": before,
                "ops": [re.match(r"\s*(\S+)\s+blocks=(\d+)", ln).groups()
                        for ln in lines]}

    out = both(program)
    assert "not been executed" in out["before"]
    assert [name for name, _ in out["ops"]] == ["Read", "MapBatches", "Limit"]


# ---------------------------------------------------------------- files
def _write_parquet(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(5)
    for i in range(3):
        pq.write_table(pa.table({"x": rng.integers(0, 100, 10),
                                 "y": rng.standard_normal(10)}),
                       str(tmp_path / f"part-{i}.parquet"))
    return str(tmp_path)


def _write_csv(tmp_path):
    p = tmp_path / "data.csv"
    p.write_text("a,b,c\n1,x,0.5\n2,y,1.5\n3,z,-2.0\n")
    return str(p)


def _write_json(tmp_path):
    import json

    rng = np.random.default_rng(6)
    p = tmp_path / "rows.jsonl"
    p.write_text("\n".join(json.dumps({"a": int(v), "b": f"s{i}"})
                           for i, v in enumerate(rng.integers(0, 9, 6))))
    return str(p)


FILES = {
    "parquet": (_write_parquet, lambda rd, path: rd.read_parquet(path)),
    "parquet_columns": (_write_parquet,
                        lambda rd, path: rd.read_parquet(path, columns=["y"])),
    "csv": (_write_csv, lambda rd, path: rd.read_csv(path)),
    "json": (_write_json, lambda rd, path: rd.read_json(path)),
}


@pytest.mark.parametrize("fmt", sorted(FILES))
def test_read_files(both, tmp_path, fmt):
    pytest.importorskip("pyarrow")
    write, read = FILES[fmt]
    path = write(tmp_path)

    def program(p):
        ds = read(p.rd, path)
        return {"rows": ds.take_all(), "schema": ds.schema()}

    both(program)


def test_write_parquet_and_from_pandas(both, tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")

    def program(p):
        out = tmp_path / p.rd.__name__
        files = p.rd.range(40, parallelism=3).write_parquet(str(out))
        back = p.rd.read_parquet(str(out))
        df = pd.DataFrame({"x": [1, 2, 3], "y": [1.0, 2.0, 3.0]})
        return {"files": [f.rsplit("/", 1)[1] for f in files],
                "back": back.take_all(),
                "pandas": p.rd.from_pandas([df, df]).take_all()}

    both(program)
