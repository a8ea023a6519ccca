"""Cohort-resident client state: the K-sized store behind a sampled round
(counterpart of repro/core/client_store.py).

The per-client state a server carries (SCAFFOLD's control variates
``ServerState.c_k``, the carried AA columns ``hist_s``/``hist_y``, the wire's
per-tag comm buffers) is O(K·d), but a round computes only on its sampled
cohort of C clients. ``ClientStateStore`` is the seam between the two:

  * the store holds the [K, ...] tensors (made by ``init_state``; on the
    card the engine keeps them in its static buffers);
  * ``gather(idx)`` gives the cohort's [C, ...] rows (``index_select`` on
    dim 0, contiguous), the only view a round core sees;
  * ``scatter(idx, rows)`` writes the updated rows back, out of place
    (``index_copy`` on dim 0; the indices are unique, a cohort is drawn
    without replacement). Rows outside the cohort keep their bits: a
    client that sat the round out advances neither its error-feedback
    residual nor its difference-coding reference.

A field that is None stays None through gather and scatter, and a field
that is None in the ``scatter`` update comes back as the same tensor
object, so no op touches state the round never advanced (the engine's
live/stop select passes such a field through by identity too).

The ``comm`` slot is ``{tag: {"ef"/"ref": [K, ...]}}``, the port's own
layout, plus the robustness layer's reserved keys, each holding its tensor
directly: ``__fault_anchor__`` (the stale anchors, [K, d]),
``__async_buf__`` ([K, d]) and ``__async_age__`` ([K] int32), the deadline
gate's buffered deltas and their ages (repro_torch/robust). Riding the comm
slot is what carries them through gather and scatter.

On the sharded runtime (core/sharded.py) rank r of W owns the clients
``[r·P, (r+1)·P)``, P = K/W, and their store rows, and computes a block of
Q = C/W slots of the drawn [C] cohort: slot j on rank j // Q.
``RowExchange`` moves the rows between the two: ``gather`` brings each slot
its client's data and store rows from the owner, ``scatter`` takes the
updated rows back, and the owner writes the rows it owns. Both run in
fixed-shape collectives (every shape a function of K, C and W, never of the
draw), so a round makes no host read and a CUDA graph can hold them; the
rows travel as raw bytes, copied and never summed, so they arrive bit for
bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function


def gather_rows(tree, idx: torch.Tensor):
    """The [C, ...] rows ``idx`` of every tensor of a [K, ...] tensor or a
    nested dict of them."""
    if isinstance(tree, dict):
        return {k: gather_rows(v, idx) for k, v in tree.items()}
    return tree.index_select(0, idx)


def scatter_rows(full, idx: torch.Tensor, rows):
    """``full`` with rows ``idx`` replaced by ``rows``, out of place, for a
    tensor or a nested dict of them (``rows`` has the same keys); the other
    rows keep their bits."""
    if isinstance(full, dict):
        return {k: scatter_rows(v, idx, rows[k]) for k, v in full.items()}
    return full.index_copy(0, idx, rows)


class ClientStateStore(NamedTuple):
    """The per-client [K, ...] fields of a ServerState as one gather/scatter
    unit. Build it with :meth:`from_state`; fields the algorithm does not
    carry are None and pass through untouched."""

    c_k: "torch.Tensor | None" = None     # [K, d] client control variates
    hist_s: "torch.Tensor | None" = None  # [K, H, d] carried AA columns
    hist_y: "torch.Tensor | None" = None
    comm: "dict | None" = None            # {tag: {"ef"/"ref": [K, d]}} and
                                          # the reserved robust/ keys

    @classmethod
    def from_state(cls, state) -> "ClientStateStore":
        return cls(c_k=state.c_k, hist_s=state.hist_s, hist_y=state.hist_y,
                   comm=state.comm)

    @property
    def num_clients(self) -> int:
        for f in self:
            while isinstance(f, dict) and f:
                f = next(iter(f.values()))
            if isinstance(f, torch.Tensor):
                return f.shape[0]
        raise ValueError("an empty ClientStateStore has no client axis")

    def gather(self, idx: torch.Tensor) -> "ClientStateStore":
        """The cohort's [C, ...] rows (None fields stay None)."""
        return ClientStateStore(*(None if f is None else gather_rows(f, idx)
                                  for f in self))

    def scatter(self, idx: torch.Tensor,
                rows: "ClientStateStore") -> "ClientStateStore":
        """The store with the updated [C, ...] rows written back at ``idx``.
        A field that is None in ``rows`` is returned untouched, as the same
        tensor object; rows outside ``idx`` keep their bits."""
        return ClientStateStore(*(
            full if full is None or upd is None
            else scatter_rows(full, idx, upd)
            for full, upd in zip(self, rows)))


def flat_leaves(tree) -> list:
    """The tensors of a tensor, a nested dict of them or a
    ClientStateStore, None fields skipped, in a fixed order (fields in
    order, dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in flat_leaves(tree[k])]
    return [t for f in tree for t in flat_leaves(f)]


def unflat_leaves(like, leaves: list):
    """``like`` (as ``flat_leaves`` walks it) with its tensors replaced,
    in order, by ``leaves`` (consumed from the front)."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return leaves.pop(0)
    if isinstance(like, dict):
        return {k: unflat_leaves(like[k], leaves) for k in sorted(like)}
    return type(like)(*(unflat_leaves(f, leaves) for f in like))


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """[R, ...] rows as [R, bytes] uint8 (a view of a contiguous tensor)."""
    return t.contiguous().reshape(t.shape[0], -1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[R, bytes] uint8 rows (contiguous) back as [R, *like.shape[1:]] of
    like's dtype."""
    return b.view(like.dtype).reshape(b.shape[0], *like.shape[1:])


class RowExchange:
    """A sharded cohort round's row moves over the ranks of ``group``: K
    clients, P = K/W owned by each rank, a cohort of C, Q = C/W slots
    computed by each. Slot j is computed by rank j // Q; client k is owned
    by rank k // P, at its row k mod P.

    ``gather`` (the move in): every rank packs, for all C slots, its own
    row at ``idx mod P`` of every tensor (a valid row whoever owns the
    client) into one [C, bytes] buffer; one ``all_to_all_single`` with
    equal splits of Q rows hands rank s the ranks' rows of its slots, and
    it keeps, for slot j, the row that came from j's owner. ``scatter``
    (the move back): one ``all_gather_into_tensor`` of the ranks' [Q,
    bytes] updated rows gives every rank all C of them, in slot order; the
    owner writes each row it owns into a copy of its P rows, with one more
    row that takes every slot it does not own and is then dropped (so no
    two kept rows share an index, and the write is deterministic).

    Each rank sends C rows a move in (C·(W−1)/W of them to other ranks),
    where (C/W)·(W−1)/W rows a rank is the least the move needs, and its
    Q rows to each of the W−1 others a move back; ``row_bytes`` holds the
    bytes of one row of each move ("in", "back"), set by the round's
    shapes. The byte buffers are allocated at the first round and reused by
    every later one (the engine's CUDA graph holds them). At W = 1 both
    collectives are copies. NCCL moves the rows on the device, gloo stages
    them through the host; both are bit-exact."""

    def __init__(self, group, rank: int, world: int, num_clients: int,
                 cohort_size: int):
        self.group, self.rank, self.world = group, rank, world
        self.per_rank = num_clients // world
        self.slots = cohort_size // world
        self.cohort_size = cohort_size
        self.row_bytes: "dict[str, int]" = {}
        self._bufs: "dict[tuple, torch.Tensor]" = {}

    @property
    def mine(self) -> slice:
        """This rank's slots of the [C] cohort."""
        return slice(self.rank * self.slots, (self.rank + 1) * self.slots)

    def _buffer(self, name: str, shape: tuple, device) -> torch.Tensor:
        """The byte buffer ``name`` of ``shape``, made at its first use."""
        b = self._bufs.get((name, device))
        if b is None or tuple(b.shape) != shape:
            b = self._bufs[(name, device)] = torch.empty(
                shape, dtype=torch.uint8, device=device)
        return b

    def _pack(self, buf: torch.Tensor, parts: list) -> None:
        off = 0
        for p in parts:
            b = _as_bytes(p)
            buf[:, off:off + b.shape[1]].copy_(b)
            off += b.shape[1]

    @staticmethod
    def _widths(leaves: list) -> list:
        return [t[:1].numel() * t.element_size() for t in leaves]

    def gather(self, idx: torch.Tensor, leaves: list) -> list:
        """This rank's [Q, ...] rows of each [P, ...] tensor of ``leaves``,
        the rows of the clients ``idx[mine]`` (``idx`` [C]: the global ids,
        the same on every rank), from their owners."""
        if not leaves:
            return []
        P, Q, C = self.per_rank, self.slots, self.cohort_size
        dev = idx.device
        widths = self._widths(leaves)
        self.row_bytes["in"] = sum(widths)
        send = self._buffer("send", (C, sum(widths)), dev)
        recv = self._buffer("recv", (C, sum(widths)), dev)
        local = torch.remainder(idx, P)
        self._pack(send, [t.index_select(0, local) for t in leaves])
        with record_function("fl.cohort_exchange"):
            dist.all_to_all_single(recv, send, group=self.group)
        # recv row s·Q + i came from rank s, for slot rank·Q + i
        owner = torch.div(idx[self.mine], P, rounding_mode="floor")
        pick = owner * Q + torch.arange(Q, device=dev)
        out, off = [], 0
        for t, nb in zip(leaves, widths):
            out.append(_from_bytes(recv[:, off:off + nb].index_select(0, pick),
                                   t))
            off += nb
        return out

    def scatter(self, idx: torch.Tensor, fulls: list, rows: list) -> list:
        """Each [P, ...] tensor of ``fulls`` with the cohort's updated rows
        (``rows``: this rank's [Q, ...] rows of each, for its slots)
        written at the rows this rank owns; the other rows keep their
        bits. Out of place."""
        if not fulls:
            return []
        P, Q, C = self.per_rank, self.slots, self.cohort_size
        dev = idx.device
        widths = self._widths(rows)
        self.row_bytes["back"] = sum(widths)
        send = self._buffer("back_send", (Q, sum(widths)), dev)
        got = self._buffer("back_recv", (C, sum(widths)), dev)
        self._pack(send, rows)
        with record_function("fl.cohort_exchange"):
            _all_gather(got, send, group=self.group)
        owner = torch.div(idx, P, rounding_mode="floor")
        # the rows this rank owns land at idx mod P, every other slot on
        # row P, which is dropped
        to = torch.where(owner == self.rank, torch.remainder(idx, P), P)
        out, off = [], 0
        for full, nb in zip(fulls, widths):
            new = _from_bytes(got[:, off:off + nb].contiguous(), full)
            out.append(torch.cat([full, full[:1]]).index_copy(0, to, new)[:P])
            off += nb
        return out


def _all_gather(out: torch.Tensor, rows: torch.Tensor, group=None) -> None:
    """``out`` [W·R, ...] = the ranks' ``rows`` [R, ...] in rank order:
    torch's ``all_gather_single`` where this torch has it, else its older
    name ``all_gather_into_tensor``."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, rows, group=group)
