"""Turn the JAX package's arrays into the port's tensors.

Takes the reference's parameters, ``ServerState`` fields (params, t and
the comm buffers) and ``StackedClients`` fields as numpy arrays
(``np.asarray`` of the JAX arrays) — this module imports nothing of JAX —
and returns the port's counterparts on ``device`` with the same dtypes and
values, so both packages can start from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.algorithms import ServerState
from repro_torch.core.problem import StackedClients


def tensor(a, device: "str | torch.device" = DEFAULT_DEVICE) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (dtype and values kept)."""
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def params(p, device: "str | torch.device" = DEFAULT_DEVICE) -> torch.Tensor:
    """The reference's flat [d] parameters (logreg/linreg)."""
    p = np.asarray(p)
    if p.ndim != 1:
        raise ValueError(f"the port's params are one flat [d] array; got "
                         f"shape {p.shape}")
    return tensor(p, device)


def server_state(p, t, comm=None,
                 device: "str | torch.device" = DEFAULT_DEVICE) -> ServerState:
    """The reference ServerState's params, t and comm (its nested
    ``{tag: {"ef"|"ref": [K, d]}}`` dict of wire buffers, or None). Its
    SCAFFOLD control variates are not read by the SVRG family, and its PRNG
    key has no counterpart: the port draws a codec's uniforms from its own
    seed (core/algorithms.py::make_round_fn)."""
    return ServerState(params(p, device), int(np.asarray(t)),
                       comm_state(comm, device))


def comm_state(comm, device: "str | torch.device" = DEFAULT_DEVICE):
    """The reference's ``ServerState.comm`` as the port's: the same tags and
    buffers, each a [K, d] tensor on ``device``; None stays None."""
    if comm is None:
        return None
    out = {}
    for tag, bufs in comm.items():
        for name, a in bufs.items():
            if np.ndim(a) != 2:
                raise ValueError(f"comm[{tag!r}][{name!r}]: the port's buffers "
                                 f"are [K, d]; got shape {np.shape(a)}")
        out[tag] = {name: tensor(a, device) for name, a in bufs.items()}
    return out


def stacked_clients(x, y, mask, weight,
                    device: "str | torch.device" = DEFAULT_DEVICE
                    ) -> StackedClients:
    """The reference StackedClients' x [K, n, d], y [K, n], mask [K, n] and
    weight [K]."""
    return StackedClients(*(tensor(a, device) for a in (x, y, mask, weight)))
