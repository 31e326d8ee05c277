"""DatasetPipeline — windowed, optionally repeating execution.

ref: python/ray/data/dataset_pipeline.py (Dataset.window /
Dataset.repeat -> DatasetPipeline; per-window lazy transforms;
pipeline.split for per-worker ingest). A pipeline is a sequence of
WINDOWS — each a small Dataset over a slice of the source's read tasks —
executed one window at a time, so a transform chain over a dataset far
larger than cluster memory holds only one window's blocks live, and
epoch-style training loops (`ds.window(...).repeat()`) re-read from
source instead of materializing everything.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional

from .plan import SourceOp


class DatasetPipeline:
    """A lazy sequence of Dataset windows. `length` is None for infinite
    pipelines (repeat() without a count)."""

    def __init__(self, window_factories: Callable[[], Iterator],
                 length: Optional[int]):
        # window_factories: zero-arg callable returning a FRESH iterator
        # of () -> Dataset thunks (so the pipeline can be consumed, and
        # split children can iterate, independently)
        self._factories = window_factories
        self.length = length

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_windows(thunks: List[Callable[[], Any]]) -> "DatasetPipeline":
        return DatasetPipeline(lambda: iter(list(thunks)), len(thunks))

    # -- transforms (applied per window, lazily) -----------------------------

    def _map_windows(self, f: Callable[[Any], Any],
                     length: Optional[int] = -1) -> "DatasetPipeline":
        factories = self._factories

        def gen():
            for thunk in factories():
                yield (lambda t=thunk: f(t()))
        return DatasetPipeline(gen,
                               self.length if length == -1 else length)

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return self._map_windows(lambda ds: ds.map_batches(fn, **kw))

    def map(self, fn, **kw) -> "DatasetPipeline":
        return self._map_windows(lambda ds: ds.map(fn, **kw))

    def filter(self, fn, **kw) -> "DatasetPipeline":
        return self._map_windows(lambda ds: ds.filter(fn, **kw))

    def random_shuffle(self, **kw) -> "DatasetPipeline":
        """Per-window shuffle (the reference's pipeline shuffle scope:
        global shuffles don't fit a windowed execution model)."""
        return self._map_windows(lambda ds: ds.random_shuffle(**kw))

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        """Cycle the pipeline's windows `times` times (None = forever) —
        the epoch loop (ref: dataset_pipeline.py repeat)."""
        if self.length is None:
            raise ValueError("cannot repeat an already-infinite pipeline")
        factories = self._factories

        def gen():
            if times is None:
                while True:
                    yield from factories()
            else:
                for _ in range(times):
                    yield from factories()
        return DatasetPipeline(
            gen, None if times is None else self.length * times)

    # -- consumption ---------------------------------------------------------

    def iter_windows(self) -> Iterator:
        for thunk in self._factories():
            yield thunk()

    def iter_batches(self, **kw) -> Iterator[Dict]:
        for ds in self.iter_windows():
            yield from ds.iter_batches(**kw)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for ds in self.iter_windows():
            yield from ds.iter_rows()

    def take(self, n: int) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        if self.length is None:
            raise ValueError("cannot count an infinite pipeline")
        return sum(ds.count() for ds in self.iter_windows())

    def split(self, n: int) -> List["DatasetPipeline"]:
        """Round-robin windows into n sub-pipelines — one per Train
        worker (ref: dataset_pipeline.py split)."""
        if self.length is None:
            raise ValueError("split an infinite pipeline before repeat()")
        thunks = list(self._factories())
        return [DatasetPipeline.from_windows(thunks[i::n])
                for i in range(n)]

    def __repr__(self):
        n = "inf" if self.length is None else self.length
        return f"DatasetPipeline(windows={n})"


def window_dataset(ds, *, blocks_per_window: int = 10) -> DatasetPipeline:
    """Dataset.window implementation: slice the source's read tasks into
    windows; the transform tail re-applies per window."""
    from .dataset import Dataset

    from .plan import AllToAllOp

    if not ds._ops or not isinstance(ds._ops[0], SourceOp):
        raise ValueError("window() needs a source-rooted dataset")
    if getattr(ds, "_limit", None) is not None:
        raise ValueError(
            "window() after limit() is unsupported: the limit is applied "
            "at iteration time and would silently vanish per window — "
            "call limit() on the pipeline output instead (take(n))")
    for op in ds._ops[1:]:
        if isinstance(op, AllToAllOp):
            raise ValueError(
                f"window() cannot re-apply the GLOBAL op "
                f"{getattr(op, 'name', op.kind)!r} per window (a windowed "
                f"sort/groupby/shuffle would be window-local and silently "
                f"wrong); apply it per window AFTER windowing "
                f"(pipe.random_shuffle()) or materialize first")
    src: SourceOp = ds._ops[0]
    tail = ds._ops[1:]
    if src.read_fns is None and src.refs is None \
            and getattr(src, "thunk", None) is not None:
        # deferred source (union/zip/split view): windowing needs a
        # concrete block list — run the upstream plans once, into a
        # LOCAL SourceOp (mutating the shared op would freeze these
        # blocks into every other derived view of `ds`)
        src = SourceOp(refs=list(src.thunk()), name=src.name)
    items = src.read_fns if src.read_fns is not None else src.refs
    use_fns = src.read_fns is not None
    nwin = max(1, math.ceil(len(items) / blocks_per_window))
    thunks = []
    for w in range(nwin):
        chunk = items[w * blocks_per_window:(w + 1) * blocks_per_window]
        op = (SourceOp(read_fns=chunk, name=f"{src.name}[w{w}]") if use_fns
              else SourceOp(refs=chunk, name=f"{src.name}[w{w}]"))
        thunks.append(lambda op=op: Dataset([op] + list(tail), ds._ctx))
    return DatasetPipeline.from_windows(thunks)


def repeat_dataset(ds, times: Optional[int] = None) -> DatasetPipeline:
    """Dataset.repeat: the whole dataset as one window, cycled (each
    epoch re-executes the read tasks — nothing is pinned across
    epochs)."""
    return DatasetPipeline.from_windows([lambda: ds]).repeat(times)
