"""The port's input pipelines (`data.csv`, `data.text`, `data.parquet`,
`data.torch_adapter`) held against the JAX package's on the same seeded
files: every batch bitwise equal (`np.array_equal`), at each rank, world
size and repeat setting. Then two gloo ranks of the port's pytorch
worker read a Parquet file through `TorchParquetDataset`, and a tiny f32
LoRA decoder trains 5 steps from the same text files in both packages.

The JAX package's data modules are jax-free, but importing them runs
`tf_yarn_tpu/__init__.py`, which imports JAX: they are imported inside
the tests, so the launched tasks that import this module by name (the
pytorch worker's experiment fn below) stay light.
"""

import importlib
import json
import logging
import os
import zlib

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
import pyarrow.parquet as pq  # noqa: E402

from tf_yarn_tpu_torch.data import csv as t_csv  # noqa: E402
from tf_yarn_tpu_torch.data import parquet as t_parquet  # noqa: E402
from tf_yarn_tpu_torch.data import text as t_text  # noqa: E402
from tf_yarn_tpu_torch.data import torch_adapter as t_adapter  # noqa: E402


def _jax(module):
    return importlib.import_module(f"tf_yarn_tpu.data.{module}")


def _equal_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            a_value = a[key].numpy() if torch.is_tensor(a[key]) else a[key]
            b_value = b[key].numpy() if torch.is_tensor(b[key]) else b[key]
            assert a_value.dtype == b_value.dtype, key
            assert np.array_equal(a_value, b_value), key
    return len(got)


# ---------------------------------------------------------------- csv


@pytest.fixture
def csv_file(tmp_path):
    path = tmp_path / "wine.csv"
    lines = ["a;b;c;quality"]
    rng = np.random.RandomState(0)
    for i in range(103):
        lines.append(f"{rng.rand():.3f};{rng.randn():.4f};{rng.randint(9)};"
                     f"{i % 7}")
    path.write_text("\n".join(lines))
    return str(path)


def test_load_csv_and_split_match_jax(csv_file):
    j_csv = _jax("csv")
    for columns in (None, ["c", "a"]):
        got = t_csv.load_csv(csv_file, "quality", feature_columns=columns)
        want = j_csv.load_csv(csv_file, "quality", feature_columns=columns)
        _equal_batches([got], [want])
        assert got["x"].dtype == np.float32 and got["y"].dtype == np.int32
    data = t_csv.load_csv(csv_file, "quality")
    for fraction, buckets in ((0.2, 100), (0.5, 10)):
        got = t_csv.train_test_split(data, fraction, buckets)
        want = j_csv.train_test_split(data, fraction, buckets)
        _equal_batches(got, want)
        assert len(got[0]["y"]) + len(got[1]["y"]) == 103


def test_load_csv_refuses_an_empty_file(tmp_path):
    path = tmp_path / "empty.csv"
    path.write_text("a;quality\n")
    with pytest.raises(ValueError, match="no rows"):
        t_csv.load_csv(str(path), "quality")


@pytest.mark.parametrize("shuffle,seed,rank,world,repeat", [
    (False, 0, 0, 1, False),
    (True, 0, 0, 1, False),
    (True, 3, 1, 2, False),
    (False, 0, 2, 3, False),
    (True, 5, 1, 3, True),
])
def test_batch_iterator_matches_jax(csv_file, shuffle, seed, rank, world,
                                    repeat):
    data = t_csv.load_csv(csv_file, "quality")
    kwargs = dict(shuffle=shuffle, repeat=repeat, seed=seed, rank=rank,
                  world_size=world)
    got = t_csv.batch_iterator(data, 10, **kwargs)
    want = _jax("csv").batch_iterator(data, 10, **kwargs)
    if repeat:  # four epochs' worth of an endless stream
        count = 4 * (len(data["y"][rank::world]) // 10)
        got = [next(got) for _ in range(count)]
        want = [next(want) for _ in range(count)]
    n = _equal_batches(got, want)
    assert n >= 3


# ---------------------------------------------------------------- text


def _tokenize(line):
    """A stdlib word hash: the same ids in every process."""
    return [zlib.crc32(word.encode()) % 256 for word in line.split()]


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.RandomState(0)
    words = ["w%d" % i for i in range(50)]
    paths = []
    for part in range(2):
        lines = []
        for i in range(60):
            lines.append(" ".join(rng.choice(words, rng.randint(1, 12))))
            if i % 13 == 0:
                lines.append("   ")  # blank lines are skipped, not counted
        path = tmp_path / f"corpus-{part}.txt"
        path.write_text("\n".join(lines))
        paths.append(str(path))
    return paths


def test_pack_tokens_matches_jax():
    docs = [[1] * 10, [2] * 10, list(range(7)), [], [9] * 3]
    got = list(t_text.pack_tokens(iter(docs), 8))
    want = list(_jax("text").pack_tokens(iter(docs), 8))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert got[1].tolist() == [1, 1, 2, 2, 2, 2, 2, 2]


@pytest.mark.parametrize("rank,world,repeat", [
    (0, 1, False), (0, 2, False), (1, 2, False), (2, 3, False),
    (1, 2, True),
])
def test_text_dataset_matches_jax(corpus, rank, world, repeat):
    args = (corpus, _tokenize, 2, 16)
    kwargs = dict(rank=rank, world_size=world, repeat=repeat)
    got = iter(t_text.TextDataset(*args, **kwargs))
    want = iter(_jax("text").TextDataset(*args, **kwargs))
    if repeat:
        count = 3 * len(list(t_text.TextDataset(*args, rank=rank,
                                                world_size=world)))
        got = [next(got) for _ in range(count)]
        want = [next(want) for _ in range(count)]
    n = _equal_batches(got, want)
    assert n >= 2
    assert t_text.TextDataset(corpus, _tokenize, 2, 16).paths == corpus
    assert t_text.TextDataset(corpus[0], _tokenize, 2, 16).paths == corpus[:1]


def test_text_dataset_shards_lines_disjointly(corpus):
    seen = []
    for rank in range(2):
        ds = t_text.TextDataset(corpus, lambda line: [0], 1, 1,
                                rank=rank, world_size=2)
        seen.append(sum(1 for _ in ds._token_stream()))
    lines = sum(1 for path in corpus for line in open(path) if line.strip())
    assert sum(seen) == lines and abs(seen[0] - seen[1]) <= 1


def test_text_dataset_repeat_without_a_window_raises_as_jax(tmp_path):
    path = tmp_path / "short.txt"
    path.write_text("a b c\n")
    for module in (t_text, _jax("text")):
        ds = module.TextDataset(str(path), _tokenize, 1, 16, repeat=True)
        with pytest.raises(ValueError, match="produced no full 16-token window"):
            next(iter(ds))
        # Without repeat the same file is just empty.
        assert list(module.TextDataset(str(path), _tokenize, 1, 16)) == []


# ---------------------------------------------------------------- parquet


@pytest.fixture
def parquet_files(tmp_path):
    """Two files, 100 and 37 rows, row groups of 32 and 10."""
    rng = np.random.RandomState(0)
    paths = []
    for index, (rows, group) in enumerate(((100, 32), (37, 10))):
        start = 0 if index == 0 else 100
        table = pa.table({
            "x": np.arange(start, start + rows, dtype=np.float32),
            "y": (np.arange(start, start + rows) % 3).astype(np.int32),
            "f": rng.randn(rows).astype(np.float64),
        })
        path = str(tmp_path / f"data-{index}.parquet")
        pq.write_table(table, path, row_group_size=group)
        paths.append(path)
    return paths


def test_parquet_num_samples_matches_jax(parquet_files):
    got = t_parquet.ParquetDataset(parquet_files, batch_size=8).num_samples()
    want = _jax("parquet").ParquetDataset(parquet_files,
                                          batch_size=8).num_samples()
    assert got == want == 137


@pytest.mark.parametrize("batch,rank,world,columns", [
    (8, 0, 1, None),
    (5, 0, 4, None),
    (5, 3, 4, ["x"]),
    (7, 1, 2, ["y", "x"]),
    (16, 2, 3, None),
])
def test_parquet_batches_match_jax(parquet_files, batch, rank, world, columns):
    kwargs = dict(batch_size=batch, rank=rank, world_size=world,
                  columns=columns)
    got = list(t_parquet.ParquetDataset(parquet_files, **kwargs))
    want = list(_jax("parquet").ParquetDataset(parquet_files, **kwargs))
    n = _equal_batches(got, want)
    assert n == (137 // world) // batch if world > 1 else 137 // batch
    assert all(len(b["x"]) == batch for b in got)


def test_parquet_sharding_is_disjoint_and_complete(parquet_files):
    world = 4
    per_rank = [np.concatenate([b["x"] for b in t_parquet.ParquetDataset(
        parquet_files, batch_size=1, rank=r, world_size=world)])
        for r in range(world)]
    union = np.sort(np.concatenate(per_rank))
    # 137 rows over 4 ranks: 34 each, the global tail of 1 dropped.
    assert [len(rows) for rows in per_rank] == [34] * 4
    assert len(np.unique(union)) == 136
    for rank, rows in enumerate(per_rank):
        assert (rows.astype(np.int64) % world == rank).all()


def test_parquet_equal_counts_at_uneven_rows_as_jax(tmp_path):
    # 79 rows over 2 ranks: 40 and 39 rows; both emit (79 // 2) // 8 = 4.
    path = str(tmp_path / "uneven.parquet")
    pq.write_table(pa.table({"x": np.arange(79, dtype=np.float32)}), path,
                   row_group_size=32)
    counts = {}
    for name, module in (("port", t_parquet), ("jax", _jax("parquet"))):
        counts[name] = [len(list(module.ParquetDataset(
            path, batch_size=8, rank=r, world_size=2))) for r in range(2)]
    assert counts["port"] == counts["jax"] == [4, 4]


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3)])
def test_parquet_repeat_matches_jax(parquet_files, rank, world):
    # Batches straddle epochs: the buffers persist across them.
    kwargs = dict(batch_size=50, rank=rank, world_size=world, repeat=True)
    got = iter(t_parquet.ParquetDataset(parquet_files, **kwargs))
    want = iter(_jax("parquet").ParquetDataset(parquet_files, **kwargs))
    _equal_batches([next(got) for _ in range(7)],
                   [next(want) for _ in range(7)])


def test_parquet_zero_batch_warning_and_repeat_error_as_jax(tmp_path, caplog):
    path = str(tmp_path / "small.parquet")
    pq.write_table(pa.table({"x": np.arange(6, dtype=np.float32)}), path)
    for module in (t_parquet, _jax("parquet")):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            batches = list(module.ParquetDataset(path, batch_size=4, rank=0,
                                                 world_size=2))
        assert batches == []
        assert "emits ZERO batches" in caplog.text
        # Rank 7 of 8 owns no row of 6: repeating forever cannot work.
        ds = module.ParquetDataset(path, batch_size=1, rank=7, world_size=8,
                                   repeat=True)
        with pytest.raises(ValueError, match="owns no rows"):
            next(iter(ds))
    # Under repeat a rank with fewer rows an epoch than a batch still
    # makes batches: 3 rows an epoch, batches of 4.
    ds = t_parquet.ParquetDataset(path, batch_size=4, rank=0, world_size=2,
                                  repeat=True)
    it = iter(ds)
    assert next(it)["x"].tolist() == [0, 2, 4, 0]


def test_parquet_filesystem_is_passed_to_pyarrow(parquet_files):
    import pyarrow.fs as pafs

    local = pafs.LocalFileSystem()
    got = list(t_parquet.ParquetDataset(parquet_files, batch_size=16,
                                        filesystem=local))
    want = list(t_parquet.ParquetDataset(parquet_files, batch_size=16))
    assert _equal_batches(got, want) == 137 // 16


def test_string_columns_stay_object_arrays_and_torch_refuses_them(tmp_path):
    """pyarrow gives a string column as an object array; the adapter's
    `torch.from_numpy` raises on it in both packages (no conversion)."""
    path = str(tmp_path / "strings.parquet")
    pq.write_table(pa.table({"s": [f"r{i}" for i in range(8)],
                             "x": np.arange(8, dtype=np.int64)}), path)
    got = list(t_parquet.ParquetDataset(path, batch_size=4))
    want = list(_jax("parquet").ParquetDataset(path, batch_size=4))
    assert got[0]["s"].dtype == object
    _equal_batches(got, want)
    j_adapter = _jax("torch_adapter")
    for adapter, module in ((t_adapter, t_parquet),
                            (j_adapter, _jax("parquet"))):
        ds = adapter.TorchParquetDataset(module.ParquetDataset(path, 4))
        with pytest.raises(TypeError):
            next(iter(ds))


# ---------------------------------------------------------------- torch adapter


def _loader_rows(dataset, num_workers, context=None):
    loader = torch.utils.data.DataLoader(dataset, batch_size=None,
                                         num_workers=num_workers,
                                         multiprocessing_context=context)
    return list(loader)


def test_torch_parquet_dataset_single_process_matches_jax(parquet_files):
    j_adapter = _jax("torch_adapter")
    got = t_adapter.TorchParquetDataset(
        t_parquet.ParquetDataset(parquet_files, batch_size=8))
    want = j_adapter.TorchParquetDataset(
        _jax("parquet").ParquetDataset(parquet_files, batch_size=8))
    assert got.yields_batches and got.shards_by_rank
    batches = list(got)
    assert all(torch.is_tensor(b["x"]) for b in batches)
    assert _equal_batches(batches, list(want)) == 137 // 8
    assert _equal_batches(_loader_rows(got, 0), batches) == 137 // 8


def test_torch_parquet_dataset_two_loader_workers_match_jax(parquet_files,
                                                            monkeypatch):
    """num_workers=2: each loader worker reads the shard (rank·2 + id)
    of 2·world; together they read every row once, as JAX's adapter.
    The port's workers are spawned, as the pytorch worker's may be: they
    have no process group and read RANK and WORLD_SIZE."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    j_adapter = _jax("torch_adapter")
    got = _loader_rows(t_adapter.TorchParquetDataset(
        t_parquet.ParquetDataset(parquet_files, batch_size=4)), 2, "spawn")
    want = _loader_rows(j_adapter.TorchParquetDataset(
        _jax("parquet").ParquetDataset(parquet_files, batch_size=4)), 2)
    _equal_batches(got, want)
    # Rank 1 of 2 with 2 loader workers: shards 2 and 3 of 4.
    shards = [np.concatenate([b["x"] for b in t_parquet.ParquetDataset(
        parquet_files, batch_size=4, rank=r, world_size=4)]) for r in (2, 3)]
    assert np.array_equal(np.sort(np.concatenate([b["x"].numpy() for b in got])),
                          np.sort(np.concatenate(shards)))


def test_data_package_exports_parquet_dataset():
    from tf_yarn_tpu_torch import data

    assert data.ParquetDataset is t_parquet.ParquetDataset
    assert sorted(data.__all__) == ["ParquetDataset", "prefetch"]


# ---------------------------------------------------------------- launched ranks

TASK_ENV = {"PYTHONPATH": os.pathsep.join(
    [os.path.dirname(os.path.abspath(__file__)),
     os.environ.get("PYTHONPATH", "")])}


def parquet_rank_experiment(data_path, out_dir):
    """Each pytorch worker writes the rows its loader gave it and the
    loader's batch count to rank-<r>.json."""
    from tf_yarn_tpu_torch import pytorch as pt
    from tf_yarn_tpu_torch.data.parquet import ParquetDataset
    from tf_yarn_tpu_torch.data.torch_adapter import TorchParquetDataset

    dataset = TorchParquetDataset(
        ParquetDataset(data_path, batch_size=8, columns=["id", "x"]))

    def main_fn(model, loader, device, rank, tb_writer):
        ids, xs = [], []
        for batch in loader:
            ids.extend(batch["id"].tolist())
            xs.extend(batch["x"].tolist())
        with open(os.path.join(out_dir, f"rank-{rank}.json"), "w") as fh:
            json.dump({"id": ids, "x": xs}, fh)

    return pt.PytorchExperiment(model=torch.nn.Linear(2, 1), main_fn=main_fn,
                                train_dataset=dataset)


def test_two_gloo_ranks_read_jax_shards(tmp_path):
    from tf_yarn_tpu_torch import client, pytorch
    from tf_yarn_tpu_torch.topologies import TaskSpec

    rng = np.random.RandomState(0)
    data_path = str(tmp_path / "train.parquet")
    pq.write_table(pa.table({"id": np.arange(67, dtype=np.int64),
                             "x": rng.randn(67).astype(np.float32)}),
                   data_path, row_group_size=20)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    pytorch.run_on_gpu(
        client.get_safe_experiment_fn(
            "test_torch_data.parquet_rank_experiment", data_path,
            str(out_dir)),
        {"worker": TaskSpec(instances=2)}, env=TASK_ENV, poll_every_secs=0.3)
    j_parquet = _jax("parquet")
    seen = []
    for rank in range(2):
        got = json.load(open(out_dir / f"rank-{rank}.json"))
        want = list(j_parquet.ParquetDataset(data_path, 8, columns=["id", "x"],
                                             rank=rank, world_size=2))
        assert got["id"] == np.concatenate([b["id"] for b in want]).tolist()
        assert np.array_equal(np.asarray(got["x"], np.float32),
                              np.concatenate([b["x"] for b in want]))
        seen.append(got["id"])
    # 67 rows over 2 ranks: (67 // 2) // 8 = 4 batches each, disjoint.
    assert [len(ids) for ids in seen] == [32, 32]
    assert not set(seen[0]) & set(seen[1])


# ---------------------------------------------------------------- text -> LoRA


def test_text_fed_lora_training_matches_jax(corpus):
    """The tiny f32 LoRA decoder (flash, fused norms) trained 5 steps on
    the same text files: the port through `train_and_evaluate` fed by its
    `TextDataset` (int32 tokens, made int64 where the loop places the
    batch), the JAX package's jitted train step fed by its own; losses
    within 2e-5 relative (f32 sums in another order, through Adam)."""
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.models import transformer as jt
    from tf_yarn_tpu.training import TrainState, build_train_step

    from tf_yarn_tpu_torch import experiment as t_experiment
    from tf_yarn_tpu_torch import training as t_training
    from tf_yarn_tpu_torch.models import transformer as tt
    from tf_yarn_tpu_torch.models.weights import from_flax

    import flax.linen as nn

    seq, batch = 16, 2
    jcfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, attention_impl="flash", fused_norms=True,
        scan_layers=False, remat=False, max_seq_len=64, lora_rank=4)
    pcfg = tt.TransformerConfig.tiny(
        dtype=torch.float32, attention_impl="flash", fused_norms=True,
        scan_layers=False, remat=True, max_seq_len=64, lora_rank=4)
    variables = nn.meta.unbox(jt.Transformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32)))
    fill = np.random.RandomState(7)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(
            fill.randn(*leaf.shape).astype(np.float32) * 0.05)
        if path[-1].key == "lora_b" else leaf, variables)

    j_exp = jt.make_experiment(jcfg, batch_size=batch, seq_len=seq,
                               learning_rate=1e-3)
    j_state = TrainState(np.int32(0), variables,
                         j_exp.optimizer.init(variables))
    j_step = jax.jit(build_train_step(j_exp.model, j_exp.loss_fn,
                                      j_exp.optimizer))
    j_batches = iter(_jax("text").TextDataset(corpus, _tokenize, batch, seq,
                                              repeat=True))
    j_losses = []
    for _ in range(5):
        j_state, metrics = j_step(j_state, next(j_batches),
                                  jax.random.PRNGKey(0))
        j_losses.append(float(metrics["loss"]))

    t_exp = tt.make_experiment(
        pcfg, train_steps=5, batch_size=batch, seq_len=seq,
        learning_rate=1e-3, log_every_steps=1,
        input_fn=lambda: iter(t_text.TextDataset(corpus, _tokenize, batch,
                                                 seq, repeat=True)))

    def init_fn(device, seed):
        model = tt.Transformer(pcfg, device=device, trainable=True)
        model.load_state_dict(from_flax(
            jax.tree_util.tree_map(np.asarray, variables), pcfg))
        return model

    seen, losses = [], []
    loss_fn = t_exp.loss_fn

    def recording_loss(model, batch_, train=True):
        loss, aux = loss_fn(model, batch_, train=train)
        if train:
            seen.append(batch_["tokens"])
            losses.append(float(loss.detach()))
        return loss, aux

    t_exp.init_fn, t_exp.loss_fn = init_fn, recording_loss
    t_training.train_and_evaluate(t_experiment.as_core_experiment(t_exp),
                                  device="cpu")
    assert all(tokens.dtype == torch.int64 for tokens in seen)
    want = [b["tokens"] for b, _ in zip(
        t_text.TextDataset(corpus, _tokenize, batch, seq, repeat=True),
        range(5))]
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(seen, want))
    np.testing.assert_allclose(losses, j_losses, rtol=2e-5)
    assert losses[0] != losses[-1]
