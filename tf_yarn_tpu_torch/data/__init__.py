"""Input pipelines of the port, copies of tf_yarn_tpu/data/: `prefetch`,
`ParquetDataset` (and `torch_adapter.TorchParquetDataset` over it),
`csv` and `text`."""

from tf_yarn_tpu_torch.data.parquet import ParquetDataset
from tf_yarn_tpu_torch.data.prefetch import prefetch

__all__ = ["ParquetDataset", "prefetch"]
