"""ray_tpu_torch.data — lazy, streaming, distributed datasets.

Equivalent of Ray Data (ref: python/ray/data/): logical plan + streaming
executor over ray_tpu_torch tasks/actor pools, columnar numpy blocks in the
object store, sharded ingest for ray_tpu_torch.train workers.

Counterpart of ray_tpu/data, with its public names and metric names, over
the port's runtime. It runs on the host: its one device path is
``iter_torch_batches`` / ``block_to_torch``, whose ``device=None`` is the
CUDA card (the reference's default is the CPU). Paths that need pyarrow,
pandas, tensorflow or PIL raise an ImportError naming the package.
"""
from .block import Block
from .context import DataContext
from .dataset import (ActorPoolStrategy, Dataset, GroupedDataset,
                      from_arrow, from_blocks, from_items, from_numpy, range, read_csv,
                      read_images, read_json, read_numpy,
                      read_parquet, read_sql, read_tfrecords,
                      read_webdataset)
from .pipeline import DatasetPipeline
from .iterator import DataShard, Shardable
from .feed import DataFeed

__all__ = [
    "ActorPoolStrategy", "Block", "DataContext", "DataFeed", "DataShard",
    "Dataset", "Shardable",
    "GroupedDataset", "from_arrow", "from_blocks", "from_items", "from_numpy", "range",
    "DatasetPipeline",
    "read_csv", "read_images", "read_json", "read_numpy",
    "read_parquet", "read_sql", "read_tfrecords", "read_webdataset",
]
