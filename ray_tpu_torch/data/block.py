"""Block representation for ray_tpu_torch.data (counterpart of
ray_tpu/data/block.py).

The reference's blocks are Arrow tables / pandas DataFrames moved through
plasma (ref: python/ray/data/block.py, _internal/arrow_block.py). Here the
canonical block is a **columnar dict of numpy arrays** — the zero-copy
friendly layout for feeding torch (`torch.from_numpy(col)` shares the
buffer; one copy to the card; no row pivot on the hot path). Rows are a
derived view.

The machine the port runs on has neither pyarrow, pandas nor tensorflow:
the Arrow, DataFrame and tf conversions raise an ImportError naming the
package (`missing_package`) instead of importing it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence

import numpy as np

Block = Dict[str, np.ndarray]


def missing_package(package: str, what: str) -> ImportError:
    """The error of a data-plane path that needs a package the port does
    not depend on (ROADMAP A10: pyarrow, pandas, tensorflow, PIL)."""
    return ImportError(
        f"{what} needs {package}, which ray_tpu_torch does not depend on "
        f"(ROADMAP A10, the data plane: blocks are numpy columns); "
        f"convert to numpy first")


def _as_column(values: List[Any]) -> np.ndarray:
    try:
        arr = np.asarray(values)
        if arr.dtype == object:
            raise ValueError
        return arr
    except Exception:
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = v
        return arr


def block_from_items(items: Sequence[Any]) -> Block:
    """Rows that are dicts become columns; bare values become column 'item'."""
    if not items:
        return {}
    if isinstance(items[0], dict):
        cols: Dict[str, List[Any]] = {k: [] for k in items[0]}
        for row in items:
            for k in cols:
                cols[k].append(row.get(k))
        return {k: _as_column(v) for k, v in cols.items()}
    return {"item": _as_column(list(items))}


def block_from_batch(batch: Any) -> Block:
    """Accept a columnar dict, a pandas DataFrame, a pyarrow Table, torch
    tensors, or a list of rows."""
    if batch is None:
        return {}
    if isinstance(batch, dict):
        return {k: _any_to_numpy(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return block_from_items(list(batch))
    if type(batch).__module__.startswith("pyarrow"):  # Arrow Table
        return arrow_to_block(batch)
    if hasattr(batch, "to_dict") and hasattr(batch, "columns"):  # DataFrame
        return {c: batch[c].to_numpy() for c in batch.columns}
    if isinstance(batch, np.ndarray):
        return {"item": batch}
    raise TypeError(f"Cannot convert {type(batch).__name__} to a block")


def _any_to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if type(v).__module__.startswith("torch"):
        return v.detach().cpu().numpy()
    if type(v).__module__.startswith("pyarrow"):
        raise missing_package("pyarrow", "an Arrow column")
    return np.asarray(v)


# -- Arrow interop (ref: python/ray/data/block.py BlockAccessor.to_arrow /
# _internal/arrow_block.py): the port carries no pyarrow ----------------------

def arrow_to_block(table) -> Block:
    raise missing_package("pyarrow", "an Arrow table")


def block_to_arrow(block: Block):
    raise missing_package("pyarrow", "block_to_arrow")


def block_to_torch(block: Block, dtypes=None, device=None):
    """dict of torch tensors on ``device`` (the port's rule: None is the
    CUDA card, through ``resolve_device``; "cpu" keeps the zero-copy
    ``torch.from_numpy`` views). Ref: python/ray/data/iterator.py
    iter_torch_batches; air/_internal/torch_utils.py
    convert_ndarray_batch_to_torch_tensor_batch."""
    import torch

    from .._device import resolve_device

    dev = resolve_device(device)
    out = {}
    for k, v in block.items():
        if v.dtype == object:
            raise TypeError(f"column {k!r} has object dtype; cast it "
                            f"before iter_torch_batches")
        arr = np.ascontiguousarray(v)
        if not arr.flags.writeable:
            arr = arr.copy()  # torch rejects non-writable zero-copy views
        t = torch.from_numpy(arr)
        dt = dtypes.get(k) if isinstance(dtypes, dict) else dtypes
        if dt is not None:
            t = t.to(dt)
        if dev.type != "cpu":
            t = t.to(dev)
        out[k] = t
    return out


def block_num_rows(block: Block) -> int:
    for col in block.values():
        return len(col)
    return 0


def block_slice(block: Block, start: int, stop: int) -> Block:
    return {k: v[start:stop] for k, v in block.items()}


def block_select(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def block_concat(blocks: Iterable[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b) > 0]
    if not blocks:
        return {}
    keys = list(blocks[0].keys())
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_to_rows(block: Block) -> List[Dict[str, Any]]:
    n = block_num_rows(block)
    keys = list(block.keys())
    rows = [{k: block[k][i] for k in keys} for i in range(n)]
    # unbox the bare-value column
    if keys == ["item"]:
        return [r["item"] for r in rows]
    return rows


def block_to_batch(block: Block, batch_format: str = "numpy") -> Any:
    if batch_format in ("numpy", "default", None):
        return dict(block)
    if batch_format == "pandas":
        raise missing_package("pandas", 'batch_format="pandas"')
    if batch_format in ("pyarrow", "arrow"):
        return block_to_arrow(block)
    if batch_format == "torch":
        # a UDF's batch stays on the host, as the reference's does
        return block_to_torch(block, device="cpu")
    if batch_format in ("tf", "tensorflow"):
        return block_to_tf(block)
    if batch_format == "rows":
        return block_to_rows(block)
    raise ValueError(f"Unknown batch_format {batch_format!r}")


def block_size_bytes(block: Block) -> int:
    total = 0
    for v in block.values():
        if v.dtype == object:
            total += sum(len(str(x)) for x in v) + 8 * len(v)
        else:
            total += v.nbytes
    return total

def block_to_tf(block, dtypes=None):
    """Columns -> dict of tf.Tensors in the reference; the port carries
    no tensorflow."""
    raise missing_package("tensorflow", "block_to_tf")
