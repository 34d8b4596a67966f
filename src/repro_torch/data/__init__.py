"""Data substrate: synthetic datasets, the non-IID partitioner and the
device-resident federated store with its per-round and per-client
minibatch streams."""
from .device import (DATA_STREAM, DeviceDataStore, client_round_indices,
                     data_stream_key, estimate_store_bytes,
                     from_client_datasets, gather_participant_rounds,
                     gather_round, round_indices,
                     round_indices_client_stream, sample_round,
                     sample_round_client_stream, store_bytes)
from .noniid import shard_noniid
from .synthetic import Dataset, make_mnist_like

__all__ = ["Dataset", "make_mnist_like", "shard_noniid", "DATA_STREAM",
           "DeviceDataStore", "data_stream_key", "from_client_datasets",
           "gather_round", "round_indices", "sample_round",
           "client_round_indices", "round_indices_client_stream",
           "sample_round_client_stream", "gather_participant_rounds",
           "store_bytes", "estimate_store_bytes"]
