"""Device-resident federated data store (counterpart of
``repro.data.device``, its device path with both minibatch streams).

* :class:`DeviceDataStore` — each client's shard padded to a shared
  ``[K, N_max, ...]`` block with a per-client ``lengths`` vector, resident on
  the device the simulation runs on.
* :func:`round_indices` draws round ``t``'s ``[K, L, B]`` minibatch indices
  from ``uniform(fold_in(data_key, t), (K, L, B))``, where
  ``data_key = fold_in(PRNGKey(seed), 0x0DA7A)``: bit-identical to the JAX
  stream, so both packages train on the same examples in the same order.
* The per-client stream (:func:`client_round_indices`) keys client ``k``'s
  ``[L, B]`` draw ``fold_in(fold_in(data_key, t), k)``, so any subset of
  clients is sampled without touching the others: the sparse engine gathers
  only its participants (:func:`gather_participant_rounds`).
* The partitioners :func:`shard_assignment` (the paper's §V-A label
  shards) and :func:`dirichlet_assignment` (Dirichlet(α) heterogeneity)
  are index operations on the draws of :mod:`repro_torch.random`, so they
  give JAX's assignments; :func:`assignment_to_store` packs one into a
  store.
* :class:`StreamingSampler` keeps the padded blocks in pinned host memory
  and serves round chunks of the same :func:`round_indices` stream: the
  gather runs on the host, the copy on a side CUDA stream.
  :func:`choose_data_path` picks ``"device"`` or ``"stream"`` from the
  store's footprint against :func:`device_memory_budget`.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Sequence

import torch

from .. import random as jr
from .. import resolve_device
from .synthetic import Dataset

#: fold_in tag separating the minibatch stream from the participation stream.
DATA_STREAM = 0x0DA7A


class DeviceDataStore(NamedTuple):
    """Padded per-client shards: ``x[k, :lengths[k]]`` are client k's
    examples; rows beyond ``lengths[k]`` are zeros and never sampled."""

    x: torch.Tensor        # [K, N_max, ...] inputs, zero-padded
    y: torch.Tensor        # [K, N_max] int32 labels, zero-padded
    lengths: torch.Tensor  # [K] int32 valid example counts

    @property
    def num_clients(self) -> int:
        return self.x.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.x, self.y, self.lengths))


def data_stream_key(seed_or_key, device=None) -> torch.Tensor:
    """Minibatch-stream key for a simulation seed (or an existing key)."""
    key = (seed_or_key if isinstance(seed_or_key, torch.Tensor)
           else jr.PRNGKey(seed_or_key, device=device))
    return jr.fold_in(key, DATA_STREAM)


def _pack_clients(clients: Sequence[Dataset], device: torch.device,
                  pad_to: int | None = None, pin: bool = False):
    """Pad and pack shards into ``(x [K, cap, ...], y [K, cap] int32,
    counts)`` on ``device`` (pinned host memory with ``pin``): the one
    packing the device store and the stream sampler share, so their batches
    are the same bits."""
    counts = [int(c.y.shape[0]) for c in clients]
    if min(counts) == 0:
        raise ValueError("every client shard must be non-empty")
    cap = pad_to or max(counts)
    if cap < max(counts):
        raise ValueError(f"pad_to={cap} < largest shard ({max(counts)})")
    sample = tuple(clients[0].x.shape[1:])
    x = torch.zeros((len(clients), cap) + sample, dtype=clients[0].x.dtype,
                    device=device, pin_memory=pin)
    y = torch.zeros((len(clients), cap), dtype=torch.int32, device=device,
                    pin_memory=pin)
    for k, c in enumerate(clients):
        x[k, :counts[k]] = c.x.to(device)
        y[k, :counts[k]] = c.y.to(device=device, dtype=torch.int32)
    return x, y, counts


def from_client_datasets(clients: Sequence[Dataset], device=None,
                         pad_to: int | None = None) -> DeviceDataStore:
    """Pack per-client shards into one store padded to the largest shard,
    or to ``pad_to`` (a cap stores of several severities share), on
    ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    x, y, counts = _pack_clients(clients, device, pad_to)
    return DeviceDataStore(x, y, torch.tensor(counts, dtype=torch.int32,
                                              device=device))


def _scaled_indices(u: torch.Tensor, length) -> torch.Tensor:
    """Uniforms ``[..., L, B]`` as int32 indices below ``length`` (``[...]``,
    broadcast), never in the padding."""
    n = torch.clamp(torch.as_tensor(length, device=u.device), min=1) \
        .to(torch.float32)[..., None, None]
    idx = torch.floor(u * n).to(torch.int32)
    return torch.minimum(idx, (n - 1.0).to(torch.int32))


def round_key_indices(round_key: torch.Tensor, lengths: torch.Tensor,
                      local_iters: int, batch_size: int,
                      stream: str = "round") -> torch.Tensor:
    """``[K, L, B]`` int32 example indices of a round from its key
    ``fold_in(data_key, t)``: ``uniform(round_key, (K, L, B))`` on the
    round stream, client ``k``'s ``uniform(fold_in(round_key, k), (L, B))``
    on the per-client one (``stream="client"``).  The engine indexes a
    run's table of round keys (:func:`repro_torch.random.fold_in_range`)
    and draws here, with nothing copied to the card."""
    K = lengths.shape[0]
    if stream == "client":
        ks = torch.arange(K, device=lengths.device)
        u = jr.uniform(jr.fold_in(round_key, ks), (local_iters, batch_size))
    else:
        u = jr.uniform(round_key, (K, local_iters, batch_size),
                       device=lengths.device)
    return _scaled_indices(u, lengths)


def round_indices(data_key: torch.Tensor, t, lengths: torch.Tensor,
                  local_iters: int, batch_size: int) -> torch.Tensor:
    """``[K, L, B]`` int32 example indices for round ``t`` from
    ``fold_in(data_key, t)`` only — uniform over each client's valid rows,
    with replacement.  A tensor of rounds ``[C]`` gives ``[C, K, L, B]``,
    each row the one-round draw."""
    return round_key_indices(jr.fold_in(data_key, t), lengths, local_iters,
                             batch_size)


def gather_round(store: DeviceDataStore, idx: torch.Tensor):
    """``([..., K, L, B, ...], [..., K, L, B])`` batches for index blocks
    ``idx: [..., K, L, B]``."""
    rows = torch.arange(store.num_clients, device=idx.device)[:, None, None]
    idx = idx.long()
    return store.x[rows, idx], store.y[rows, idx]


def sample_round(store: DeviceDataStore, data_key: torch.Tensor, t,
                 local_iters: int, batch_size: int):
    """One round's stacked client batches, sampled on the store's device."""
    return gather_round(store, round_indices(data_key, t, store.lengths,
                                             local_iters, batch_size))


def sample_batch(store: DeviceDataStore, data_key: torch.Tensor, t,
                 batch_size: int):
    """Single-local-iter convenience: ``([K, B, ...], [K, B])``."""
    xb, yb = sample_round(store, data_key, t, 1, batch_size)
    return xb[:, 0], yb[:, 0]


def stack_rounds_reference(store: DeviceDataStore, data_key: torch.Tensor,
                           rounds: int, local_iters: int, batch_size: int):
    """The stream of :func:`sample_round` for every round, stacked into the
    ``[T, K, L, B, ...]`` layout of the prestack path: bit for bit what the
    device path gathers at each ``t``."""
    ts = torch.arange(rounds, device=store.lengths.device)
    return gather_round(store, round_indices(data_key, ts, store.lengths,
                                             local_iters, batch_size))


def label_histogram(store: DeviceDataStore, num_classes: int) -> torch.Tensor:
    """Per-client label counts ``[K, C]`` (int32) over each client's valid
    rows."""
    valid = (torch.arange(store.y.shape[1], device=store.y.device)[None, :]
             < store.lengths[:, None])
    lab = torch.where(valid, store.y.long(), num_classes)
    hist = torch.zeros((store.num_clients, num_classes + 1),
                       dtype=torch.int64, device=store.y.device)
    hist.scatter_add_(1, lab, torch.ones_like(lab))
    return hist[:, :num_classes].to(torch.int32)


# ---------------------------------------------------------------------------
# per-client stream: indices a client draws without touching the other K-1
# ---------------------------------------------------------------------------


def client_round_indices(data_key: torch.Tensor, t, client_id, length,
                         local_iters: int, batch_size: int) -> torch.Tensor:
    """``[..., L, B]`` int32 example indices of clients ``client_id`` at
    round ``t``, from ``uniform(fold_in(fold_in(data_key, t), k), (L, B))``.

    ``t``, ``client_id`` and ``length`` broadcast together (numbers or
    tensors): each lane is the JAX function for one ``(t, k)``.  Draws are
    uniform over ``[0, length)`` with replacement and never land in the
    padding."""
    key = jr.fold_in(jr.fold_in(data_key, t), client_id)
    return _scaled_indices(jr.uniform(key, (local_iters, batch_size)),
                           length)


def round_indices_client_stream(data_key: torch.Tensor, t,
                                lengths: torch.Tensor, local_iters: int,
                                batch_size: int) -> torch.Tensor:
    """Dense ``[K, L, B]`` form of the per-client stream: row ``k`` is
    exactly :func:`client_round_indices` for client ``k``, so gathering a
    subset of rows equals sampling that subset directly."""
    return round_key_indices(jr.fold_in(data_key, t), lengths, local_iters,
                             batch_size, stream="client")


def sample_round_client_stream(store: DeviceDataStore,
                               data_key: torch.Tensor, t, local_iters: int,
                               batch_size: int):
    """The dense engine's sampler on the per-client stream
    (``SimConfig.data_stream="client"``), the bit-parity reference of the
    sparse path."""
    return gather_round(store, round_indices_client_stream(
        data_key, t, store.lengths, local_iters, batch_size))


def gather_participant_rounds(store: DeviceDataStore, data_key: torch.Tensor,
                              part_idx: torch.Tensor, local_iters: int,
                              batch_size: int):
    """Batches of every round's transmitting set, participant-sized.

    ``part_idx: [T, P]`` client ids, padding lanes holding ``K``.  Returns
    ``([T, P, L, B, ...], [T, P, L, B])``: the store is touched only by a
    row gather per participant.  As in JAX, a padding lane hashes the raw
    id ``K`` (a stream no client uses) and gathers the clamped client
    ``K-1``'s rows; the sparse engine gives those lanes weight 0."""
    K = store.num_clients
    ts = torch.arange(part_idx.shape[0], device=part_idx.device)[:, None]
    kc = torch.clamp(part_idx.long(), 0, K - 1)
    bidx = client_round_indices(data_key, ts, part_idx, store.lengths[kc],
                                local_iters, batch_size).long()
    rows = kc[..., None, None]
    return store.x[rows, bidx], store.y[rows, bidx]


# ---------------------------------------------------------------------------
# footprint
# ---------------------------------------------------------------------------


def store_bytes(num_clients: int, cap: int, sample_shape: Sequence[int],
                itemsize: int = 4) -> int:
    """Exact padded-store footprint from its shape parameters, term for term
    :attr:`DeviceDataStore.nbytes`: the ``[K, N_max, ...]`` inputs, the
    ``[K, N_max]`` int32 labels and the ``[K]`` int32 lengths.  Python ints
    throughout, so a K ~ 10⁹ planning query cannot overflow."""
    row = math.prod(int(s) for s in sample_shape)
    k, cap = int(num_clients), int(cap)
    return k * cap * (row * int(itemsize) + 4) + k * 4


def estimate_store_bytes(clients: Sequence[Dataset]) -> int:
    """What :func:`from_client_datasets` would allocate for ``clients``,
    without building it."""
    counts = [int(c.y.shape[0]) for c in clients]
    x = clients[0].x
    return store_bytes(len(clients), max(counts), tuple(x.shape[1:]),
                       x.element_size())


# ---------------------------------------------------------------------------
# non-IID partitioners: index operations on JAX's draws
# ---------------------------------------------------------------------------


def assignment_to_store(x: torch.Tensor, y: torch.Tensor,
                        assign: torch.Tensor, num_clients: int,
                        cap: int) -> DeviceDataStore:
    """An example → client assignment ``[N]`` as a padded store on
    ``x``'s device: a stable sort by client, then each client reads its
    contiguous slice, ``cap`` rows a client (more are cut, fewer padded
    with zeros)."""
    N = y.shape[0]
    assign = assign.to(x.device).long()
    order = torch.argsort(assign, stable=True)
    counts = torch.bincount(assign, minlength=num_clients)
    starts = torch.cumsum(counts, 0) - counts
    ar = torch.arange(cap, device=x.device)
    pos = starts[:, None] + ar[None, :]
    lengths = torch.clamp(counts, max=cap).to(torch.int32)
    valid = ar[None, :] < lengths[:, None]
    idx = order[torch.clamp(pos, 0, N - 1)]
    xk = torch.where(valid.reshape(valid.shape + (1,) * (x.dim() - 1)),
                     x[idx], 0).to(x.dtype)
    yk = torch.where(valid, y.to(x.device)[idx].to(torch.int32), 0)
    return DeviceDataStore(xk, yk.to(torch.int32), lengths)


def dirichlet_assignment(key: torch.Tensor, y: torch.Tensor,
                         num_clients: int, alpha: float,
                         num_classes: int) -> torch.Tensor:
    """Dirichlet(α) non-IID assignment ``[N] -> client`` (int32, on the
    key's device).

    Each client k draws class preferences ``p_k ~ Dirichlet(α·1_C)``; an
    example of label c goes to client k with probability ∝ ``p_k[c]``, by
    ``argmax`` over clients of ``log p_k[c] + gumbel``.  Small α: each
    client holds few classes; large α: close to IID."""
    k_prop, k_gum = jr.split(key).unbind(-2)
    props = jr.dirichlet(k_prop, torch.full((num_classes,), float(alpha)),
                         shape=(num_clients,))               # [K, C]
    logp = jr._f64(torch.log, torch.clamp(props, min=1e-30))
    logits = logp[:, y.to(key.device).long()]                  # [K, N]
    gum = jr.gumbel(k_gum, (num_clients, y.shape[0]))
    return torch.argmax(logits + gum, dim=0).to(torch.int32)


def shard_assignment(key: torch.Tensor, y: torch.Tensor, num_clients: int,
                     d: int, num_classes: int) -> torch.Tensor:
    """The paper's §V-A label-shard scheme as index operations: ``[N] ->
    client`` (int32, on the key's device).

    Each class splits into ``d·K/C`` equal shards and every client gets
    ``d`` shards of distinct labels (for d ≤ C): rank the examples within
    their class (random tiebreak), cut the ranks into shards, lay the
    ``d·K`` shards column-major in a ``[C, d·K/C]`` grid so that ``d``
    consecutive slots span ``d`` classes, permute the columns within each
    class and the client ids."""
    S = d * num_clients
    if S % num_classes != 0:
        raise ValueError(f"d*K must be divisible by C={num_classes} "
                         f"(got d={d}, K={num_clients})")
    spc = S // num_classes                             # shards per class
    y = y.to(key.device).long()
    N = y.shape[0]
    k_tie, k_col, k_cli = jr.split(key, 3).unbind(-2)

    # rank within class, random order inside each class
    tie = jr.uniform(k_tie, (N,))
    order = torch.argsort(y.to(torch.float32) * 2.0 + tie, stable=True)
    counts = torch.bincount(y, minlength=num_classes)
    starts = torch.cumsum(counts, 0) - counts
    y_sorted = y[order]
    rank = torch.arange(N, device=y.device) - starts[y_sorted]
    shard_in_class = torch.clamp(
        torch.div(rank * spc, torch.clamp(counts[y_sorted], min=1),
                  rounding_mode="floor"), max=spc - 1)

    # class-local shard → grid column (random per-class permutation)
    colperm = torch.argsort(jr.uniform(k_col, (num_classes, spc)), dim=1,
                            stable=True)
    col = colperm[y_sorted, shard_in_class]
    slot = col * num_classes + y_sorted                # column-major
    cperm = jr.permutation(k_cli, num_clients)
    assign_sorted = cperm[torch.div(slot, d, rounding_mode="floor")]

    out = torch.zeros(N, dtype=torch.int32, device=y.device)
    out[order] = assign_sorted.to(torch.int32)
    return out


def _default_cap(assign: torch.Tensor, num_clients: int) -> int:
    """The largest client's example count, read back to the host; the
    chance to refuse a partition that leaves a client empty (it would
    sample padding row 0 forever).  With K > N no partition can fill every
    client, so that error comes before a ``[K]`` bincount is built."""
    n = int(assign.shape[0])
    if num_clients > n:
        raise ValueError(
            f"partition is degenerate: num_clients={num_clients} exceeds the "
            f"dataset size N={n}, so some client must end up with no "
            "examples — use a larger dataset or fewer clients")
    counts = torch.bincount(assign.long(), minlength=num_clients)
    if int(counts.min()) == 0:
        raise ValueError(
            f"partition left client {int(torch.argmin(counts))} with no "
            "examples — use a larger alpha/dataset or fewer clients")
    cap = int(counts.max())
    if cap <= 0:
        raise ValueError("partition produced a degenerate zero capacity")
    return cap


def dirichlet_store(key: torch.Tensor, ds: Dataset, num_clients: int,
                    alpha: float, cap: int | None = None) -> DeviceDataStore:
    """A dataset partitioned Dirichlet(α)-style straight into a store on
    the key's device; ``cap=None`` reads the capacity back from the
    realized counts."""
    assign = dirichlet_assignment(key, ds.y, num_clients, alpha,
                                  ds.num_classes)
    cap = cap if cap is not None else _default_cap(assign, num_clients)
    return assignment_to_store(ds.x.to(key.device), ds.y, assign,
                               num_clients, cap)


def shard_store(key: torch.Tensor, ds: Dataset, num_clients: int, d: int,
                cap: int | None = None) -> DeviceDataStore:
    """The paper's §V-A partition straight into a store (the ``cap``
    contract of :func:`dirichlet_store`)."""
    assign = shard_assignment(key, ds.y, num_clients, d, ds.num_classes)
    cap = cap if cap is not None else _default_cap(assign, num_clients)
    return assignment_to_store(ds.x.to(key.device), ds.y, assign,
                               num_clients, cap)


# ---------------------------------------------------------------------------
# footprint planning: device store or host streaming
# ---------------------------------------------------------------------------

#: the budget where the device reports none (the CPU)
DEFAULT_BUDGET_BYTES = 4 << 30
#: the share of the budget the data store may take (the model, the state
#: and the traces need the rest)
STORE_BUDGET_FRACTION = 0.5


def device_memory_budget(device=None) -> int:
    """The memory the data may plan against, in JAX's order: the
    ``REPRO_DATA_BUDGET_BYTES`` override, else the card's memory
    (``device=None`` means the card), else 4 GiB for the CPU."""
    env = os.environ.get("REPRO_DATA_BUDGET_BYTES")
    if env:
        return int(env)
    device = resolve_device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return DEFAULT_BUDGET_BYTES


def choose_data_path(clients, budget_bytes: int | None = None,
                     device=None) -> str:
    """``"device"`` when the padded store fits ``STORE_BUDGET_FRACTION`` of
    the budget, else ``"stream"``.  ``clients`` is a list of shards, a
    built :class:`DeviceDataStore` or a byte count.  T never enters: both
    paths hold the same data whatever the horizon."""
    budget = (budget_bytes if budget_bytes is not None
              else device_memory_budget(device))
    if isinstance(clients, int):
        need = clients
    elif isinstance(clients, DeviceDataStore):
        need = clients.nbytes
    else:
        need = estimate_store_bytes(clients)
    return "device" if need <= STORE_BUDGET_FRACTION * budget else "stream"


# ---------------------------------------------------------------------------
# host streaming: round chunks gathered on the host, copied ahead of use
# ---------------------------------------------------------------------------


class StreamingSampler:
    """Round chunks of the :func:`round_indices` stream, from host memory.

    The padded ``[K, N_max, ...]`` blocks stay on the host (pinned when the
    target is a card).  :meth:`chunk` draws the ``[C, K, L, B]`` indices on
    the host (integers: the device path's bits), gathers the examples on
    the host into a pinned buffer and copies it to the card with
    ``non_blocking=True`` on a side CUDA stream; the compute stream waits
    on that copy's event, and the chunk is kept from reuse until the
    compute stream has consumed it (``record_stream``).  Call it one chunk
    ahead: the copy overlaps the chunk in flight.
    """

    def __init__(self, clients: Sequence[Dataset], data_key: torch.Tensor,
                 local_iters: int, batch_size: int,
                 pad_to: int | None = None, device=None):
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        host = torch.device("cpu")
        self._x, self._y, counts = _pack_clients(clients, host, pad_to,
                                                 pin=self._pin)
        self.lengths = torch.tensor(counts, dtype=torch.int32)
        self.data_key = data_key.cpu()
        self.local_iters = local_iters
        self.batch_size = batch_size
        self._side = None
        self._held = []   # (event, pinned buffers) of copies in flight
        self.copies = 0

    @property
    def nbytes_host(self) -> int:
        return (self._x.numel() * self._x.element_size()
                + self._y.numel() * self._y.element_size())

    def indices(self, t0: int, t1: int) -> torch.Tensor:
        """``[C, K, L, B]`` int32 indices of rounds ``[t0, t1)``, each row
        :func:`round_indices` at its ``t``, drawn on the host."""
        return round_indices(self.data_key, torch.arange(t0, t1),
                             self.lengths, self.local_iters,
                             self.batch_size)

    def chunk(self, t0: int, t1: int):
        """Batches of rounds ``[t0, t1)`` on the sampler's device:
        ``([C, K, L, B, ...], [C, K, L, B])``."""
        idx = self.indices(t0, t1).long()
        K, cap = self._x.shape[:2]
        flat = (torch.arange(K)[None, :, None, None] * cap + idx).reshape(-1)
        sample = tuple(self._x.shape[2:])
        xh = torch.empty((flat.shape[0],) + sample, dtype=self._x.dtype,
                         pin_memory=self._pin)
        yh = torch.empty(flat.shape[0], dtype=torch.int32,
                         pin_memory=self._pin)
        torch.index_select(self._x.reshape((K * cap,) + sample), 0, flat,
                           out=xh)
        torch.index_select(self._y.reshape(-1), 0, flat, out=yh)
        xh = xh.reshape(idx.shape + sample)
        yh = yh.reshape(idx.shape)
        if not self._pin:
            return xh.to(self.device), yh.to(self.device)
        compute = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._side):
            xd = xh.to(self.device, non_blocking=True)
            yd = yh.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        compute.wait_event(done)
        # the side stream allocated them; the compute stream reads them
        xd.record_stream(compute)
        yd.record_stream(compute)
        # the pinned sources live until their copy has landed
        self._held = [(e, b) for e, b in self._held if not e.query()]
        self._held.append((done, (xh, yh)))
        self.copies += 1
        return xd, yd
