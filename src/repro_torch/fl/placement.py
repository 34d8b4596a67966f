"""Client-axis placement of the dense engine (JAX's ``shard_clients``).

JAX places the dense engine's client axis over a 1-D ``("k",)`` mesh of
the first d devices, d the largest divisor of K no larger than the device
count (``repro.fl.engine._client_mesh``).  Local training runs under
``shard_map`` with ``P("k")`` in and out, the device store's client axis
lies on the same mesh (``launch/sharding.py: client_axis_shardings``), and
GSPMD carries the placement through the pseudo-gradients, eq. 3 and the
broadcast: the client rows stay split for the whole run.  The port writes
that placement out:

* :class:`ClientPlacement` holds the d devices, the runner's own first,
  and K/d contiguous rows a device: block s holds rows ``[s·K/d,
  (s+1)·K/d)``, JAX's ``P("k")`` order.
* The client and anchor rows of the run's :class:`~repro_torch.fl.state.
  FLState` are :class:`~repro_torch.fl.state.RowBlocks`, made on their
  devices (``init_fl_state(..., devices=)``); the global row, the ``[K]``
  ledgers, the decision, the fault state, the taps and the eval stay on
  the first device.
* The data: the device store split along K once (:meth:`place_store`,
  ``client_axis_shardings``' rule: each of the store's leaves leads with
  K, which d divides), each round's indices drawn once on the first device
  and each block's rows gathered on its own (:class:`PlacedStore`); or the
  prestack batches split along K (:meth:`split`).
* Local SGD, the participants-mode keep, eq. 2, the corruption and the
  broadcast run a block at a time on its device
  (:func:`repro_torch.fl.engine._make_round_step`); the row reductions and
  eq. 3 as :mod:`repro_torch.fl.state` says.

A placement over a repeated device (``("cpu",) * 4``, ``("cuda:0",) *
4``) runs the same program as d blocks of one device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..data.device import DeviceDataStore, gather_round, round_key_indices
from .state import RowBlocks


@dataclasses.dataclass(frozen=True)
class ClientPlacement:
    """``devices``: the d devices, the runner's own first; K/d rows each."""

    devices: tuple
    num_clients: int

    def __post_init__(self):
        if self.num_clients % len(self.devices):
            raise ValueError(f"{len(self.devices)} devices do not divide "
                             f"K={self.num_clients}")

    @classmethod
    def over_cards(cls, device: torch.device, d: int,
                   num_clients: int) -> "ClientPlacement":
        """The runner's card and then the other visible cards in index
        order, d of them."""
        first = device.index
        if first is None:
            first = (torch.cuda.current_device()
                     if torch.cuda.is_available() else 0)
        others = [i for i in range(torch.cuda.device_count()) if i != first]
        return cls(tuple(torch.device("cuda", i)
                         for i in [first, *others][:d]), num_clients)

    @property
    def rows(self) -> int:
        """Rows a block, K/d."""
        return self.num_clients // len(self.devices)

    def split(self, v: torch.Tensor, dim: int = 0) -> RowBlocks:
        """``v`` with K along ``dim`` as :class:`RowBlocks`, block s (its
        K/d clients along ``dim``) on device s."""
        n = self.rows
        return RowBlocks(v.narrow(dim, s * n, n).to(dev).contiguous()
                         for s, dev in enumerate(self.devices))

    def place_store(self, store: DeviceDataStore) -> "PlacedStore":
        """``store``'s client axis over the devices (every leaf split along
        K, each block moved from wherever the store lies to its device),
        with the ``[K]`` lengths kept whole on the first device for the
        draw."""
        parts = [self.split(v) for v in store]
        return PlacedStore(store.lengths.to(self.devices[0]),
                           tuple(DeviceDataStore(*leaves)
                                 for leaves in zip(*parts)))


class PlacedStore(NamedTuple):
    """A :class:`~repro_torch.data.device.DeviceDataStore` over a
    placement: ``blocks[s]`` holds block s's clients on its device."""

    lengths: torch.Tensor   # [K] int32 on the first device
    blocks: tuple           # DeviceDataStore per block

    @property
    def num_clients(self) -> int:
        return self.lengths.shape[0]

    def indices(self, round_key: torch.Tensor, local_iters: int,
                batch_size: int, stream: str = "round") -> RowBlocks:
        """A round's ``[K, L, B]`` indices from its key ``fold_in(data_key,
        t)`` (:func:`~repro_torch.data.device.round_key_indices`), drawn
        once on the first device (the unplaced draw's bits), each block's
        rows on its device."""
        idx = round_key_indices(round_key, self.lengths, local_iters,
                                batch_size, stream)
        blocks = RowBlocks(b.lengths for b in self.blocks)
        return RowBlocks(blocks.slices(idx))

    def sample(self, round_key: torch.Tensor, local_iters: int,
               batch_size: int, stream: str = "round"):
        """A round's batches as :class:`RowBlocks` ``([K, L, B, ...], [K,
        L, B])`` from its key, each block gathered on its device."""
        parts = [gather_round(b, i) for b, i in zip(
            self.blocks, self.indices(round_key, local_iters, batch_size,
                                      stream))]
        return RowBlocks(x for x, _ in parts), RowBlocks(y for _, y in parts)
