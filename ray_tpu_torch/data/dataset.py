"""Dataset — the lazy, distributed data API.

Parity with the reference's Dataset (ref: python/ray/data/dataset.py;
read_api.py; plan execution via _internal/plan.py:544 → streaming
executor). Transforms are lazy logical ops; execution streams blocks
through tasks/actor pools with bounded in-flight blocks. Blocks are
columnar numpy dicts (see block.py) — the natural feed format for torch.

Counterpart of ray_tpu/data/dataset.py, over the port's runtime. Paths of
the reference that need pyarrow (parquet, Arrow), tensorflow or PIL
raise an ImportError naming the package.
"""
from __future__ import annotations

import builtins
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

from .._vendor import cloudpickle
import numpy as np

import ray_tpu_torch

from .block import (Block, block_concat, block_from_batch, block_from_items,
                    block_num_rows, block_size_bytes, block_to_batch,
                    block_to_rows)
from .context import DataContext
from .executor import StreamingExecutor
from .iterator import DataShard, Shardable, _iter_batches_from_blocks
from .plan import (AllToAllOp, MapOp, SourceOp, WindowedShuffleOp,
                   build_segments)


def _block_rows(block: Block) -> int:
    return block_num_rows(block)


def _num_rows_remote():
    """Tiny metadata task: count a block's rows where it lives (no
    transfer). Wrapped at call time — the house convention keeps
    RemoteFunction construction out of import paths."""
    return ray_tpu_torch.remote(_block_rows)


@dataclass
class ActorPoolStrategy:
    """compute= strategy running the UDF on a pool of actors (ref:
    python/ray/data/_internal/compute.py ActorPoolStrategy)."""
    size: int = 2
    resources: Optional[Dict[str, float]] = None


class Dataset(Shardable):
    def __init__(self, ops: List[Any], context: Optional[DataContext] = None):
        self._ops = ops
        self._ctx = context or DataContext.get_current()
        self._last_stats: Optional[dict] = None

    # -- transforms (lazy) ---------------------------------------------------

    def _with(self, op) -> "Dataset":
        if getattr(self, "_limit", None) is not None:
            # limit() then transform: the transform must see only the
            # truncated rows (ds.limit(3).flat_map(f) maps 3 rows, not
            # all). A deferred thunk source applies the limit when the
            # derived plan executes, keeping the chain lazy.
            src = SourceOp(thunk=self._execute_refs, name="limited")
            return Dataset([src, op], self._ctx)
        return Dataset(self._ops + [op], self._ctx)

    def map_batches(self, fn: Union[Callable, type], *,
                    batch_format: str = "numpy",
                    fn_constructor_args: tuple = (),
                    compute: Optional[ActorPoolStrategy] = None,
                    **_ignored) -> "Dataset":
        """Apply fn to whole blocks. A class UDF runs on an actor pool
        (constructed once per actor)."""
        if isinstance(fn, type):
            ctor_args = fn_constructor_args

            class _Bound:
                def __init__(self, cls=fn, args=ctor_args):
                    self._inst = cls(*args)

                def __call__(self, batch):
                    return self._inst(batch)

            inst_holder: list = []

            def block_fn(block: Block) -> Block:
                if not inst_holder:
                    inst_holder.append(_Bound())
                return block_from_batch(
                    inst_holder[0](block_to_batch(block, batch_format)))

            if compute is None:
                compute = ActorPoolStrategy()
        else:
            def block_fn(block: Block) -> Block:
                return block_from_batch(fn(block_to_batch(block, batch_format)))

        c = (compute.size, compute.resources) if compute is not None else None
        return self._with(MapOp(block_fn, name="map_batches", compute=c))

    def map(self, fn: Callable[[Any], Any]) -> "Dataset":
        def block_fn(block: Block) -> Block:
            return block_from_items([fn(r) for r in block_to_rows(block)])

        return self._with(MapOp(block_fn, name="map", commutes=True))

    def flat_map(self, fn: Callable[[Any], List[Any]]) -> "Dataset":
        def block_fn(block: Block) -> Block:
            out: List[Any] = []
            for r in block_to_rows(block):
                out.extend(fn(r))
            return block_from_items(out)

        return self._with(MapOp(block_fn, name="flat_map"))

    def filter(self, fn: Callable[[Any], bool]) -> "Dataset":
        def block_fn(block: Block) -> Block:
            rows = [r for r in block_to_rows(block) if fn(r)]
            return block_from_items(rows)

        return self._with(MapOp(block_fn, name="filter", commutes=True))

    def add_column(self, name: str, fn: Callable[[Dict[str, np.ndarray]], Any]
                   ) -> "Dataset":
        def block_fn(block: Block) -> Block:
            out = dict(block)
            out[name] = np.asarray(fn(block))
            return out

        return self._with(MapOp(block_fn, name=f"add_column[{name}]",
                                commutes=True))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def block_fn(block: Block) -> Block:
            return {k: v for k, v in block.items() if k not in cols}

        return self._with(MapOp(block_fn, name="drop_columns",
                                commutes=True))

    def select_columns(self, cols: List[str]) -> "Dataset":
        """Keep only `cols` (ref: dataset.py select_columns). Directly
        after a column-aware read (parquet) the optimizer pushes the
        projection into the read tasks, so dropped columns are never
        fetched at all."""
        cols = list(cols)

        def block_fn(block: Block) -> Block:
            missing = [c for c in cols if c not in block]
            if missing:
                raise KeyError(f"select_columns: missing {missing}; "
                               f"have {sorted(block)}")
            return {c: block[c] for c in cols}

        return self._with(MapOp(block_fn, name=f"select[{','.join(cols)}]",
                                commutes=True, projection=cols))

    def sort(self, key: str = "id", *, descending: bool = False) -> "Dataset":
        """Distributed sort by a column: sample -> range partition ->
        per-partition sort (ref: dataset.py sort;
        planner/exchange/sort_task_spec.py)."""
        return self._with(AllToAllOp("sort", (key, descending), name="sort"))

    def groupby(self, key: str) -> "GroupedDataset":
        """-> GroupedDataset with count/sum/mean/min/max aggregations
        (ref: dataset.py groupby; grouped_data.py)."""
        return GroupedDataset(self, key)

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(AllToAllOp("repartition", num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(AllToAllOp("random_shuffle", seed))

    def windowed_shuffle(self, *, window_blocks: int = 8,
                         seed: Optional[int] = None) -> "Dataset":
        """Streaming shuffle: buffer `window_blocks` upstream blocks,
        emit their rows globally permuted by a seeded RNG, move to the
        next window. Unlike random_shuffle this is NOT an all-to-all
        barrier — the consumer starts after W blocks land and peak held
        refs stay O(W) — which is the right trade for training input
        pipelines (approximate global order, streaming memory).

        The permutation is a pure function of (seed, epoch): replaying
        the same epoch via iter_epochs() yields bit-identical order,
        the next epoch reshuffles deterministically."""
        if window_blocks < 1:
            raise ValueError("window_blocks must be >= 1")
        return self._with(WindowedShuffleOp(window_blocks, seed))

    def union(self, *others: "Dataset") -> "Dataset":
        """Lazy concatenation of datasets (ref: dataset.py union):
        the inputs' plans execute when the union executes; blocks flow
        through in order."""
        parts = [self, *others]

        def thunk():
            refs: List[Any] = []
            for p in parts:
                refs.extend(p._execute_refs())
            return refs

        return Dataset([SourceOp(thunk=thunk, name="union")], self._ctx)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise zip of two equal-length datasets (ref: dataset.py
        zip — the right side's conflicting column names get a "_1"
        suffix). Blocks realign on the driver, so this materializes both
        sides; prefer add_column for derived columns."""
        def thunk():
            a = block_concat([ray_tpu_torch.get(r)
                              for r in self._execute_refs()])
            b = block_concat([ray_tpu_torch.get(r)
                              for r in other._execute_refs()])
            na, nb = block_num_rows(a), block_num_rows(b)
            if na != nb:
                raise ValueError(
                    f"zip needs equal row counts, got {na} vs {nb}")
            merged = dict(a)
            for k, v in b.items():
                name, i = k, 1
                while name in merged:  # find a FREE suffix: zipping an
                    name = f"{k}_{i}"  # already-zipped ds must not
                    i += 1             # clobber its existing k_1
                merged[name] = v
            n_blocks = max(1, min(self._ctx.default_parallelism,
                                  math.ceil(na / max(
                                      1, self._ctx.target_min_rows_per_block)
                                  )))
            refs = []
            for i in builtins.range(n_blocks):
                lo = na * i // n_blocks
                hi = na * (i + 1) // n_blocks
                if hi > lo:
                    refs.append(ray_tpu_torch.put(
                        {k: v[lo:hi] for k, v in merged.items()}))
            return refs

        return Dataset([SourceOp(thunk=thunk, name="zip")], self._ctx)

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> tuple:
        """-> (train, test) row-split at 1 - test_size (ref: dataset.py
        train_test_split). The upstream plan executes ONCE; both halves
        are views over the cached block refs."""
        if not 0.0 < test_size < 1.0:
            raise ValueError("test_size must be in (0, 1)")
        base = self.random_shuffle(seed=seed) if shuffle else self
        cache: Dict[str, Any] = {}

        def _splits():
            if "parts" not in cache:
                from .block import block_slice

                refs = base._execute_refs()
                blocks = [ray_tpu_torch.get(r) for r in refs]
                total = sum(block_num_rows(b) for b in blocks)
                cut = int(total * (1.0 - test_size))
                train_refs, test_refs, seen = [], [], 0
                for r, b in zip(refs, blocks):
                    n = block_num_rows(b)
                    if seen + n <= cut:
                        train_refs.append(r)  # whole block: reuse ref
                    elif seen >= cut:
                        test_refs.append(r)
                    else:  # only the straddling block is re-put
                        k = cut - seen
                        train_refs.append(
                            ray_tpu_torch.put(block_slice(b, 0, k)))
                        test_refs.append(
                            ray_tpu_torch.put(block_slice(b, k, n)))
                    seen += n
                cache["parts"] = (train_refs, test_refs)
            return cache["parts"]

        train = Dataset([SourceOp(thunk=lambda: list(_splits()[0]),
                                  name="train_split")], self._ctx)
        test = Dataset([SourceOp(thunk=lambda: list(_splits()[1]),
                                 name="test_split")], self._ctx)
        return train, test

    def random_sample(self, fraction: float, *,
                      seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (ref: dataset.py random_sample). Each
        block samples with its own derived seed in a remote task."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")

        def _sample(block: Block, frac: float, s: int) -> Block:
            rng = np.random.default_rng(s)
            mask = rng.random(block_num_rows(block)) < frac
            return {k: v[mask] for k, v in block.items()}

        sample_remote = ray_tpu_torch.remote(_sample)

        # unseeded calls must be independent draws (the reference's
        # contract) — freeze a fresh base per random_sample() call
        base = (int(np.random.default_rng().integers(2 ** 31))
                if seed is None else seed)

        def thunk():
            return [sample_remote.remote(r, fraction, base + 7919 * i)
                    for i, r in enumerate(self._execute_refs())]

        return Dataset([SourceOp(thunk=thunk, name="random_sample")],
                       self._ctx)

    def unique(self, column: str) -> List[Any]:
        """Distinct values of a column (ref: dataset.py unique)."""
        seen: set = set()
        for b in self._stream_blocks():
            if column in b:
                seen.update(np.unique(b[column]).tolist())
        return sorted(seen)

    def limit(self, n: int) -> "Dataset":
        """Applied exactly at iteration time (truncates the block stream)."""
        ds = Dataset(self._ops, self._ctx)
        ds._limit = n  # type: ignore[attr-defined]
        return ds

    # -- execution -----------------------------------------------------------

    def _segments(self) -> List[dict]:
        """Logical-plan optimization (optimizer.py rules) then fusion
        (plan.build_segments); applied rules surface in stats()."""
        from .optimizer import optimize

        ops, rules = optimize(self._ops)
        self._opt_rules = rules
        return build_segments(ops)

    def _execute_refs(self) -> List[Any]:
        ex = StreamingExecutor(self._ctx, epoch=getattr(self, "_epoch", 0))
        refs = list(ex.execute(self._segments()))
        self._last_stats = ex.stats.summary()
        limit = getattr(self, "_limit", None)
        if limit is not None:
            # ref-path consumers (materialize, union/zip/split thunks,
            # to_arrow_refs) must see the truncation too, not just the
            # block-stream path. Row counts come from tiny remote tasks
            # so whole-kept blocks never travel to the driver; only the
            # one straddling block is fetched and re-put sliced.
            from .block import block_slice

            nrows = _num_rows_remote()
            counts = ray_tpu_torch.get(
                [nrows.remote(r) for r in refs], timeout=600)
            kept, seen = [], 0
            for r, n in zip(refs, counts):
                if seen >= limit:
                    break
                take = min(n, limit - seen)
                kept.append(r if take == n else ray_tpu_torch.put(
                    block_slice(ray_tpu_torch.get(r), 0, take)))
                seen += take
            refs = kept
        return refs

    def _stream_blocks(self) -> Iterator[Block]:
        ex = StreamingExecutor(self._ctx, epoch=getattr(self, "_epoch", 0))
        limit = getattr(self, "_limit", None)
        seen = 0
        for ref in ex.execute(self._segments()):
            block = ray_tpu_torch.get(ref)
            if limit is not None:
                take = min(block_num_rows(block), limit - seen)
                if take <= 0:
                    break
                from .block import block_slice

                block = block_slice(block, 0, take)
                seen += take
                yield block
                if seen >= limit:
                    break
            else:
                yield block
        self._last_stats = ex.stats.summary()

    def materialize(self) -> "Dataset":
        refs = self._execute_refs()
        return Dataset([SourceOp(refs=refs, name="materialized")], self._ctx)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     local_shuffle_seed: Optional[int] = None) -> Iterator[Any]:
        return _iter_batches_from_blocks(self._stream_blocks(), batch_size,
                                         batch_format, drop_last,
                                         local_shuffle_seed)

    def iter_epochs(self, num_epochs: Optional[int] = None
                    ) -> Iterator["Dataset"]:
        """Epoch-aware re-execution for training loops: yields one
        Dataset view per epoch, each re-running THIS plan with the
        epoch index threaded into every windowed_shuffle stage — epoch
        e replays bit-identically given the same seed, epoch e+1
        reshuffles deterministically. num_epochs=None iterates forever
        (ref: dataset_pipeline.py iter_epochs; here epochs re-execute
        the lazy plan rather than replaying a pipeline log)."""
        e = 0
        while num_epochs is None or e < num_epochs:
            ds = Dataset(self._ops, self._ctx)
            lim = getattr(self, "_limit", None)
            if lim is not None:
                ds._limit = lim  # type: ignore[attr-defined]
            ds._epoch = e  # type: ignore[attr-defined]
            yield ds
            e += 1

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           dtypes=None, device=None,
                           drop_last: bool = False,
                           local_shuffle_seed: Optional[int] = None
                           ) -> Iterator[Any]:
        """Batches as dicts of torch tensors on ``device`` (None: the CUDA
        card; "cpu" shares the block's numpy columns; ref:
        data/iterator.py iter_torch_batches, whose default is the CPU)."""
        from .block import block_to_torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last,
                                       local_shuffle_seed=local_shuffle_seed):
            yield block_to_torch(batch, dtypes=dtypes, device=device)

    def iter_tf_batches(self, *, batch_size: Optional[int] = 256,
                        dtypes=None, drop_last: bool = False,
                        local_shuffle_seed: Optional[int] = None
                        ) -> Iterator[Any]:
        """Batches as dicts of tf.Tensors in the reference (dataset.py
        iter_tf_batches); the port carries no tensorflow."""
        from .block import missing_package

        raise missing_package("tensorflow", "iter_tf_batches")

    def to_arrow_refs(self) -> List[Any]:
        """Blocks as pyarrow.Table object refs in the reference
        (dataset.py to_arrow_refs); the port carries no pyarrow."""
        from .block import missing_package

        raise missing_package("pyarrow", "to_arrow_refs")

    # -- writes (ref: dataset.py write_parquet/write_csv/write_json:
    # one output file per block, written by parallel tasks) ------------------

    def _write_files(self, path: str, ext: str, write_one) -> List[str]:
        """Distributed write: each block becomes <path>/part-<i>.<ext>,
        written by a task per block. `path` may be an fsspec URL
        (s3://, gs://; memory:// is per-process and suits only
        single-process use). Writers receive an open binary file and
        must not close it. Stale part-*.<ext> files from a previous,
        larger write are removed first — a smaller re-write must not
        leave a mix a re-read would silently merge."""
        from ..util.fs import split_fs_url

        fs, root = split_fs_url(path)
        if fs is None:
            os.makedirs(root, exist_ok=True)
            for name in os.listdir(root):
                if name.startswith("part-") and name.endswith("." + ext):
                    os.unlink(os.path.join(root, name))
        else:
            try:
                fs.makedirs(root, exist_ok=True)
                for p in fs.ls(root, detail=False):
                    base = str(p).rsplit("/", 1)[-1]
                    if base.startswith("part-") \
                            and base.endswith("." + ext):
                        fs.rm(p)
            except FileNotFoundError:
                pass
        writer_blob = cloudpickle.dumps(write_one)

        @ray_tpu_torch.remote
        def _write(block, dest: str) -> str:
            from .._vendor import cloudpickle as cp

            from ..util.fs import split_fs_url as _split

            w = cp.loads(writer_blob)
            # dest keeps the user's scheme: each worker resolves the
            # filesystem itself (cloud targets are shared across hosts)
            f_fs, f_path = _split(dest)
            if f_fs is None:
                os.makedirs(os.path.dirname(f_path) or ".", exist_ok=True)
                with open(f_path, "wb") as f:
                    w(block, f)
            else:
                try:
                    f_fs.makedirs(f_path.rsplit("/", 1)[0],
                                  exist_ok=True)
                except Exception:
                    pass
                with f_fs.open(f_path, "wb") as f:
                    w(block, f)
            return dest

        # compose dests on the ORIGINAL path so the scheme survives to
        # the workers; plain local paths use the OS separator
        base = path.rstrip("/") if "://" in path else path
        sep = "/" if "://" in path else os.sep
        refs = [
            _write.remote(ref, f"{base}{sep}part-{i:06d}.{ext}")
            for i, ref in enumerate(self._execute_refs())
        ]
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str) -> List[str]:
        from .block import missing_package

        raise missing_package("pyarrow", "write_parquet")

    def write_csv(self, path: str) -> List[str]:
        def write_one(block: Block, f) -> None:
            import csv
            import io

            cols = list(block)
            buf = io.StringIO()
            w = csv.writer(buf)
            w.writerow(cols)
            # builtins.range: this module's `range` is the Dataset
            # factory (ray_tpu_torch.data.range) and shadows the builtin
            # inside functions pickled out of this namespace
            for i in builtins.range(block_num_rows(block)):
                w.writerow([block[c][i] for c in cols])
            f.write(buf.getvalue().encode())

        return self._write_files(path, "csv", write_one)

    def write_json(self, path: str) -> List[str]:
        def write_one(block: Block, f) -> None:
            import json as _json

            lines = []
            for row in block_to_rows(block):
                if isinstance(row, dict):
                    row = {k: (v.tolist() if hasattr(v, "tolist") else v)
                           for k, v in row.items()}
                elif hasattr(row, "tolist"):
                    row = row.tolist()
                lines.append(_json.dumps(row))
            f.write(("\n".join(lines) + "\n").encode())

        return self._write_files(path, "json", write_one)

    def iter_rows(self) -> Iterator[Any]:
        for block in self._stream_blocks():
            for row in block_to_rows(block):
                yield row

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            # print IS the surface here (interactive inspection API)
            print(row)  # graftcheck: disable=GC007

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self._stream_blocks())

    def sum(self, column: str = "item") -> float:
        total = 0.0
        for b in self._stream_blocks():
            if column in b and block_num_rows(b):
                total += float(np.sum(b[column]))
        return total

    def _column_stats(self, column: str) -> tuple:
        """Streaming (n, sum, sumsq, min, max) over one pass."""
        n, s, ss = 0, 0.0, 0.0
        mn, mx = math.inf, -math.inf
        for b in self._stream_blocks():
            if column in b and block_num_rows(b):
                v = np.asarray(b[column], np.float64)
                n += v.size
                s += float(v.sum())
                ss += float((v * v).sum())
                mn = min(mn, float(v.min()))
                mx = max(mx, float(v.max()))
        return n, s, ss, mn, mx

    def mean(self, column: str = "item") -> float:
        n, s, _, _, _ = self._column_stats(column)
        return s / n if n else float("nan")

    def std(self, column: str = "item", ddof: int = 1) -> float:
        """ref: dataset.py std (sample std by default, like the
        reference's ddof=1)."""
        n, s, ss, _, _ = self._column_stats(column)
        if n <= ddof:
            return float("nan")
        var = (ss - s * s / n) / (n - ddof)
        return math.sqrt(max(var, 0.0))

    def min(self, column: str = "item") -> float:
        n, _, _, mn, _ = self._column_stats(column)
        return mn if n else float("nan")

    def max(self, column: str = "item") -> float:
        n, _, _, _, mx = self._column_stats(column)
        return mx if n else float("nan")

    def schema(self) -> Optional[Dict[str, str]]:
        for b in self._stream_blocks():
            return {k: str(v.dtype) for k, v in b.items()}
        return None

    def num_blocks(self) -> int:
        src = self._ops[0]
        if src.read_fns is None and src.refs is None \
                and src.thunk is not None:
            # deferred source (union/zip/split): block count is only
            # knowable by running the upstream plans. Executed LOCALLY —
            # mutating the shared SourceOp here would silently freeze
            # one execution's blocks into every derived view (an
            # unseeded shuffle upstream would stop reshuffling)
            return len(list(src.thunk()))
        n = len(src.read_fns) if src.read_fns is not None else len(src.refs or [])
        for op in self._ops[1:]:
            if isinstance(op, AllToAllOp) and op.kind == "repartition":
                n = op.arg
        return n

    def size_bytes(self) -> int:
        return sum(block_size_bytes(b) for b in self._stream_blocks())

    def stats(self) -> dict:
        out = dict(self._last_stats or {})
        rules = getattr(self, "_opt_rules", None)
        if rules:
            out["optimizer_rules"] = list(rules)
        return out

    # -- splitting (Train ingest) --------------------------------------------

    def split_shards(self, n: int, *, equal: bool = True,
                     locality_hints=None) -> List[DataShard]:
        """Materialize and split into n shards for n Train workers (ref:
        python/ray/data/dataset.py split / streaming_split feeding
        train/_internal/data_config.py)."""
        refs = self._execute_refs()
        if equal and refs and len(refs) % n != 0 or (refs and len(refs) < n):
            ex = StreamingExecutor(self._ctx)
            per = max(1, math.ceil(len(refs) / n)) if refs else 1
            refs = ex.execute(build_segments(
                [SourceOp(refs=refs), AllToAllOp("repartition", n * per)]))
            refs = list(refs)
        return [DataShard(refs[i::n], name=f"shard_{i}") for i in builtins.range(n)]

    def split(self, n: int, **kw) -> List[DataShard]:
        return self.split_shards(n, **kw)

    def window(self, *, blocks_per_window: int = 10):
        """-> DatasetPipeline of windows over the source read tasks
        (ref: dataset.py window / dataset_pipeline.py): one window's
        blocks live at a time."""
        from .pipeline import window_dataset

        return window_dataset(self, blocks_per_window=blocks_per_window)

    def repeat(self, times: Optional[int] = None):
        """-> DatasetPipeline cycling this dataset (epochs; re-reads
        from source each pass)."""
        from .pipeline import repeat_dataset

        return repeat_dataset(self, times)

    def __repr__(self):
        names = [getattr(op, "name", op.__class__.__name__)
                 for op in self._ops]
        return f"Dataset({' -> '.join(names)})"


# ---------------------------------------------------------------------------
# read API (ref: python/ray/data/read_api.py)
# ---------------------------------------------------------------------------


class GroupedDataset:
    """Aggregations over groups of a key column. Two-stage: per-block
    partial aggregate states hash-partition by key, then merge — the
    classic map-side combine (ref: python/ray/data/grouped_data.py)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _agg(self, specs: List[tuple]) -> Dataset:
        return self._ds._with(
            AllToAllOp("groupby", (self._key, specs), name="groupby"))

    def count(self) -> Dataset:
        return self._agg([("count", None)])

    def sum(self, on: str) -> Dataset:
        return self._agg([("sum", on)])

    def mean(self, on: str) -> Dataset:
        return self._agg([("mean", on)])

    def min(self, on: str) -> Dataset:
        return self._agg([("min", on)])

    def max(self, on: str) -> Dataset:
        return self._agg([("max", on)])

    def aggregate(self, *specs: tuple) -> Dataset:
        """specs: ("count", None) / ("sum"|"mean"|"min"|"max", column)."""
        return self._agg(list(specs))


def _make_dataset(read_fns: List[Callable[[], Block]], name: str) -> Dataset:
    blobs = [cloudpickle.dumps(fn) for fn in read_fns]
    return Dataset([SourceOp(read_fns=blobs, name=name)])


def from_items(items: List[Any], *, parallelism: int = -1) -> Dataset:
    n = len(items)
    ctx = DataContext.get_current()
    if parallelism <= 0:
        parallelism = max(1, min(ctx.default_parallelism,
                                 math.ceil(n / ctx.target_min_rows_per_block)))
    parallelism = max(1, min(parallelism, n or 1))
    fns = []
    for i in builtins.range(parallelism):
        chunk = items[n * i // parallelism: n * (i + 1) // parallelism]
        fns.append(lambda c=chunk: block_from_items(c))
    return _make_dataset(fns, "from_items")


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    ctx = DataContext.get_current()
    if parallelism <= 0:
        parallelism = max(1, min(ctx.default_parallelism,
                                 math.ceil(n / ctx.target_min_rows_per_block)))
    parallelism = max(1, min(parallelism, n or 1))
    fns = []
    for i in builtins.range(parallelism):
        lo, hi = n * i // parallelism, n * (i + 1) // parallelism
        fns.append(lambda a=lo, b=hi: {"id": np.arange(a, b)})
    return _make_dataset(fns, "range")


def from_arrow(tables, *, parallelism: int = -1) -> Dataset:
    """One or more pyarrow Tables -> Dataset in the reference
    (data/read_api.py from_arrow); the port carries no pyarrow."""
    from .block import missing_package

    raise missing_package("pyarrow", "from_arrow")


def from_numpy(arrays: Union[np.ndarray, Dict[str, np.ndarray]], *,
               parallelism: int = -1) -> Dataset:
    block = block_from_batch(arrays)
    n = block_num_rows(block)
    ctx = DataContext.get_current()
    if parallelism <= 0:
        parallelism = max(1, min(ctx.default_parallelism,
                                 math.ceil(n / ctx.target_min_rows_per_block)))
    parallelism = max(1, min(parallelism, n or 1))
    fns = []
    for i in builtins.range(parallelism):
        lo, hi = n * i // parallelism, n * (i + 1) // parallelism
        sub = {k: v[lo:hi] for k, v in block.items()}
        fns.append(lambda s=sub: s)
    return _make_dataset(fns, "from_numpy")


def from_blocks(blocks: List[Block]) -> Dataset:
    return _make_dataset([lambda b=b: block_from_batch(b) for b in blocks],
                         "from_blocks")


def _file_read_fns(paths: Union[str, List[str]], reader: Callable[[str], Block],
                   suffixes: tuple) -> List[Callable[[], Block]]:
    import os

    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, f) for f in sorted(names)
                             if f.endswith(suffixes))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"No input files under {paths}")
    return [lambda f=f: reader(f) for f in files]


def read_parquet(paths: Union[str, List[str]],
                 columns: Optional[List[str]] = None, **kw) -> Dataset:
    """Parquet files -> Dataset in the reference (its reader is
    pyarrow.parquet); the port carries no pyarrow."""
    from .block import missing_package

    raise missing_package("pyarrow", "read_parquet")


def read_csv(paths: Union[str, List[str]], **kw) -> Dataset:
    def reader(path: str) -> Block:
        import csv

        with open(path, newline="") as f:
            rows = list(csv.DictReader(f))
        block = block_from_items(rows)
        out: Block = {}
        for k, v in block.items():
            try:
                out[k] = v.astype(np.float64)
            except (ValueError, TypeError):
                out[k] = v
        return out

    return _make_dataset(_file_read_fns(paths, reader, (".csv",)), "read_csv")


def read_json(paths: Union[str, List[str]], **kw) -> Dataset:
    def reader(path: str) -> Block:
        import json

        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return block_from_items(rows)

    return _make_dataset(_file_read_fns(paths, reader, (".json", ".jsonl")),
                         "read_json")


def read_numpy(paths: Union[str, List[str]], **kw) -> Dataset:
    def reader(path: str) -> Block:
        return {"data": np.load(path)}

    return _make_dataset(_file_read_fns(paths, reader, (".npy",)), "read_numpy")


def read_images(paths: Union[str, List[str]], *,
                size: Optional[tuple] = None,
                mode: str = "RGB", include_paths: bool = False,
                **kw) -> Dataset:
    """Image files -> blocks with an 'image' column in the reference
    (python/ray/data/read_api.py read_images; PIL decodes); the port
    carries no PIL."""
    from .block import missing_package

    raise missing_package("PIL", "read_images")


def read_sql(sql: str, connection_factory: Union[str, Callable], *,
             parallelism: int = 1, **kw) -> Dataset:
    """SQL query -> Dataset (ref: python/ray/data/read_api.py read_sql).
    connection_factory: a zero-arg callable returning a DB-API 2.0
    connection, or a string path treated as a sqlite3 database file.
    parallelism > 1 shards the query rows round-robin into that many
    blocks (each read task re-runs the query and keeps its slice — the
    portable strategy when the dialect lacks OFFSET pushdown)."""
    if isinstance(connection_factory, str):
        db_path = connection_factory

        def connection_factory():  # noqa: F811 — intentional rebind
            import sqlite3

            return sqlite3.connect(db_path)

    conn_blob = cloudpickle.dumps(connection_factory)

    def read_shard(shard: int, nshards: int) -> Block:
        factory = cloudpickle.loads(conn_blob)
        conn = factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            # iterate the cursor: fetchall() would hold the FULL result
            # in every shard task simultaneously (nshards x table memory)
            rows = [r for i, r in enumerate(cur) if i % nshards == shard]
        finally:
            conn.close()
        return block_from_items([dict(zip(cols, r)) for r in rows])

    n = max(1, int(parallelism))
    fns = [lambda s=s: read_shard(s, n) for s in builtins.range(n)]
    return _make_dataset(fns, "read_sql")


def read_webdataset(paths: Union[str, List[str]], *,
                    decode: bool = True, **kw) -> Dataset:
    """WebDataset tar shards -> Dataset (ref: python/ray/data/read_api.py
    read_webdataset). Each tar member group sharing a basename prefix
    (before the first dot) is one sample; columns are named by member
    extension. With decode=True: jpg/png/bmp members raise (the
    reference decodes them through PIL, which the port does not carry;
    decode=False keeps them bytes), txt/cls to str, json to parsed objects, everything else
    stays bytes. One block per tar shard — the format's unit of
    streaming."""
    def reader(path: str) -> Block:
        import json as _json
        import os
        import tarfile

        samples: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        with tarfile.open(path) as tar:
            for m in tar:
                if not m.isfile():
                    continue
                # key = FULL path up to the basename's first dot (the
                # webdataset base_plus_ext rule: train/a/0001.jpg and
                # train/b/0001.jpg are DIFFERENT samples)
                dirname, base = os.path.split(m.name)
                stem, _, ext = base.partition(".")
                key = os.path.join(dirname, stem) if dirname else stem
                data = tar.extractfile(m).read()
                if decode:
                    # decode dispatches on the LAST extension segment so
                    # 0001.seg.png decodes like 0001.png
                    lext = ext.lower().rsplit(".", 1)[-1]
                    if lext in ("jpg", "jpeg", "png", "bmp"):
                        from .block import missing_package

                        raise missing_package(
                            "PIL", f"decoding the image member {m.name!r} "
                                   f"(read_webdataset(decode=True))")
                    elif lext in ("txt", "cls"):
                        data = data.decode()
                    elif lext == "json":
                        data = _json.loads(data)
                if key not in samples:
                    samples[key] = {"__key__": key}
                    order.append(key)
                samples[key][ext] = data
        # union of extensions across samples: optional members (.cls on
        # some samples only) must not vanish because the shard's FIRST
        # sample lacked them (block_from_items seeds columns from row 0)
        all_keys: Dict[str, None] = {}
        for k in order:
            for col in samples[k]:
                all_keys.setdefault(col)
        rows = [{col: samples[k].get(col) for col in all_keys}
                for k in order]
        return block_from_items(rows)

    return _make_dataset(
        _file_read_fns(paths, reader, (".tar",)), "read_webdataset")


def read_tfrecords(paths: Union[str, List[str]], **kw) -> Dataset:
    """TFRecord files of tf.train.Example -> columnar blocks. No
    TensorFlow needed: framing + the Example protobuf subset are decoded
    natively with CRC verification (data/tfrecords.py; ref:
    python/ray/data/read_api.py read_tfrecords)."""
    from .tfrecords import tfrecords_to_block

    return _make_dataset(
        _file_read_fns(paths, tfrecords_to_block, (".tfrecord", ".tfrecords")),
        "read_tfrecords")
