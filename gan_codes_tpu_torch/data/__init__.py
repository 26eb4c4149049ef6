"""The CUB data pipeline of the port (numpy and PIL): the dataset, the
batched loader, a synthetic fixture and batch helpers."""
from .dataset import CUBDataset, load_bbox_table  # noqa: F401
from .loader import Batch, DataLoader  # noqa: F401
from .synthetic import make_synthetic_cub  # noqa: F401
