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
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
