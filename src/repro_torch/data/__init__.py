"""Data substrate: synthetic datasets, the non-IID partitioner and the
device-resident federated store with per-round sampling."""
from .device import (DATA_STREAM, DeviceDataStore, data_stream_key,
                     from_client_datasets, gather_round, round_indices,
                     sample_round)
from .noniid import shard_noniid
from .synthetic import Dataset, make_mnist_like

__all__ = ["Dataset", "make_mnist_like", "shard_noniid", "DATA_STREAM",
           "DeviceDataStore", "data_stream_key", "from_client_datasets",
           "gather_round", "round_indices", "sample_round"]
