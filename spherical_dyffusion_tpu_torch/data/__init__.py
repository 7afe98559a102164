from .coords import GridMetadata, HorizontalCoordinates, SigmaCoordinates, VariableMetadata
from .datamodule import (
    DataModuleConfig,
    DebugDataModule,
    FV3GFSDataModule,
    StochasticDataModule,
    batch_iterator,
)
from .datasets import (
    ConcatSource,
    NetCDFTimeSeries,
    StochasticModalTimeSeries,
    SyntheticTimeSeries,
    WindowedDataset,
)
from .netcdf import NetCDFFile, read_scalar_dataset
from .normalization import StandardNormalizer, get_normalizer
from .packer import Packer

__all__ = [
    "GridMetadata",
    "HorizontalCoordinates",
    "SigmaCoordinates",
    "VariableMetadata",
    "DataModuleConfig",
    "DebugDataModule",
    "FV3GFSDataModule",
    "batch_iterator",
    "ConcatSource",
    "NetCDFTimeSeries",
    "StochasticDataModule",
    "StochasticModalTimeSeries",
    "SyntheticTimeSeries",
    "WindowedDataset",
    "NetCDFFile",
    "read_scalar_dataset",
    "StandardNormalizer",
    "get_normalizer",
    "Packer",
]
