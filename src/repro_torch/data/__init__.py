"""Data substrate: synthetic datasets (the LLM's token stream too), the non-IID partitioners (the
host greedy one and the index-operation ones), host batching, and the
device-resident federated store with its per-round and per-client
minibatch streams and the host-streaming sampler."""
from .device import (DATA_STREAM, DEFAULT_BUDGET_BYTES,
                     STORE_BUDGET_FRACTION, DeviceDataStore,
                     StreamingSampler, assignment_to_store, choose_data_path,
                     client_round_indices, data_stream_key,
                     device_memory_budget, dirichlet_assignment,
                     dirichlet_store, estimate_store_bytes,
                     from_client_datasets, gather_participant_rounds,
                     gather_round, label_histogram, round_indices,
                     round_indices_client_stream, sample_batch, sample_round,
                     sample_round_client_stream, shard_assignment,
                     shard_store, stack_rounds_reference, store_bytes)
from .noniid import heterogeneity, shard_noniid
from .pipeline import BatchIterator, client_batches
from .synthetic import (Dataset, make_cifar_like, make_mnist_like,
                        make_token_stream)

__all__ = ["Dataset", "make_mnist_like", "make_cifar_like",
           "make_token_stream", "shard_noniid",
           "heterogeneity", "BatchIterator", "client_batches", "DATA_STREAM",
           "DeviceDataStore", "StreamingSampler", "choose_data_path",
           "device_memory_budget", "DEFAULT_BUDGET_BYTES",
           "STORE_BUDGET_FRACTION", "data_stream_key",
           "dirichlet_assignment", "dirichlet_store", "assignment_to_store",
           "estimate_store_bytes", "store_bytes", "from_client_datasets",
           "gather_round", "gather_participant_rounds", "label_histogram",
           "round_indices", "client_round_indices",
           "round_indices_client_stream", "sample_batch", "sample_round",
           "sample_round_client_stream", "shard_assignment", "shard_store",
           "stack_rounds_reference"]
