"""Turn the JAX package's arrays into the port's tensors.

Takes the reference's parameters, ``ServerState`` fields (params, t, the
comm buffers, the control variates and the carried AA columns),
``StackedClients`` fields, an LM's parameters and decode caches
(``lm_params``, ``lm_caches``; as the flat [d] vector the federated
problem trains, ``lm_flat_params``) and the MLP's parameters
(``mlp_params``) as numpy arrays
(``np.asarray`` of the JAX arrays) — this module imports nothing of JAX —
and returns the port's counterparts on ``device`` with the same dtypes and
values, so both packages can start from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.algorithms import ServerState
from repro_torch.core.lm import param_layout
from repro_torch.core.problem import StackedClients
from repro_torch.models.decoder import LMCaches


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


def server_state(p, t, comm=None, c=None, c_k=None, hist_s=None, hist_y=None,
                 device: "str | torch.device" = DEFAULT_DEVICE) -> ServerState:
    """The reference ServerState's params, t and comm (its nested
    ``{tag: {"ef"|"ref": [K, d]}}`` dict of wire buffers, or None), and,
    where given, SCAFFOLD's control variates c [d] and c_k [K, d] and the
    carried AA columns hist_s, hist_y [K, H, d] (the port holds them only
    for the algorithms that read them: pass the reference's c and c_k for
    the SCAFFOLD family, its hist_* when ``carry_history`` > 0). Its PRNG
    key has no counterpart: the port draws a round's uniforms and minibatch
    rows from its own seed (core/algorithms.py::make_round_fn)."""
    def opt(a):
        return None if a is None else tensor(a, device)
    return ServerState(params(p, device), int(np.asarray(t)),
                       comm_state(comm, device), opt(c), opt(c_k), opt(hist_s),
                       opt(hist_y))


def comm_state(comm, device: "str | torch.device" = DEFAULT_DEVICE):
    """The reference's ``ServerState.comm`` as the port's: the same tags and
    buffers, each a [K, d] tensor on ``device``, and the robustness layer's
    reserved keys (its dunder names), whose arrays (the [K, d] anchor and
    buffer rows, the [K] int32 ages) become tensors as they are; None stays
    None."""
    if comm is None:
        return None
    out = {}
    for tag, bufs in comm.items():
        if tag.startswith("__"):
            out[tag] = tensor(bufs, device)
            continue
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


#: the reference's stacked [n, ...] parameter groups (one module per layer
#: in the port)
_STACKED = ("blocks", "mamba_groups", "mamba_tail")


def _array_tensor(a, device) -> torch.Tensor:
    """Like ``tensor``, also for numpy's bfloat16 (ml_dtypes), which
    torch.from_numpy does not take: its bits are reinterpreted."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(resolve_device(device))
    return tensor(a, device)


def _leaves(node, prefix: str = ""):
    """(dotted path, array) for every leaf of a nested dict."""
    for name, v in node.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{name}.")
        else:
            yield prefix + name, v


def lm_params(params_np, cfg, device: "str | torch.device" = DEFAULT_DEVICE) -> dict:
    """The reference LM's parameters (its nested dict, as numpy) as the
    port's state dict: a stacked group's [n, ...] arrays become layers
    ``<group>.<i>.<path>``; everything else keeps its path. Load it with
    ``model.load_state_dict(lm_params(...))`` (strict: every name must
    match)."""
    n_layers = {"blocks": cfg.num_layers}
    if cfg.family == "hybrid":
        n_groups, group, trailing = cfg.hybrid_counts
        n_layers = {"mamba_groups": n_groups * group, "mamba_tail": trailing}
    out = {}
    for name, node in params_np.items():
        if name not in _STACKED:
            for path, a in _leaves({name: node}):
                out[path] = _array_tensor(a, device)
            continue
        for path, a in _leaves(node):
            if np.shape(a)[0] != n_layers.get(name):
                raise ValueError(f"{name}.{path}: {np.shape(a)[0]} layers, "
                                 f"expected {n_layers.get(name)} for {cfg.name}")
            for i in range(np.shape(a)[0]):
                out[f"{name}.{i}.{path}"] = _array_tensor(np.asarray(a)[i], device)
    return out


def lm_caches(caches_np, cfg, device: "str | torch.device" = DEFAULT_DEVICE):
    """The reference's decode caches (the nested dict of stacked arrays that
    its prefill or init_caches returns, as numpy) as the port's LMCaches:
    the same nesting, names, shapes and dtypes. A KV group is the
    model-dtype one (k, v, pos, idx) or the int8 one of a ``kv_quant``
    config's init_caches (int8 k, v, f32 k_scale, v_scale, pos, idx)."""
    kv, ssm = {"k", "v", "pos", "idx"}, {"conv", "ssm"}
    kv_int8 = kv | {"k_scale", "v_scale"}
    want = {"dense": kv, "vlm": kv, "audio": kv, "moe": kv, "ssm": ssm}.get(cfg.family)
    if cfg.family == "hybrid":
        want = {"mamba", "shared_kv"} | ({"tail"} if cfg.hybrid_counts[2] else set())
    if set(caches_np) != want and not (want == kv and set(caches_np) == kv_int8):
        raise ValueError(f"caches with groups {sorted(caches_np)} do not fit "
                         f"{cfg.name} ({cfg.family}): expected {sorted(want or ())}")
    if cfg.family == "hybrid" and set(caches_np["shared_kv"]) not in (kv, kv_int8):
        raise ValueError(f"shared_kv with {sorted(caches_np['shared_kv'])} is no "
                         f"KV group: expected {sorted(kv)} or {sorted(kv_int8)}")

    def conv(node):
        return {k: conv(v) if isinstance(v, dict) else _array_tensor(v, device)
                for k, v in node.items()}

    return LMCaches(conv(caches_np))


def lm_flat_params(params_np, model,
                   device: "str | torch.device" = DEFAULT_DEVICE) -> torch.Tensor:
    """The reference LM's parameters (or any tree of its shape, such as a
    gradient) as the flat [d] vector of ``make_lm_problem(model, ...)``:
    ``lm_params``'s tensors in the order of ``core/lm.py::param_layout``."""
    sd = lm_params(params_np, model.cfg, "cpu")
    return torch.cat([sd[name].reshape(-1) for name, _ in param_layout(model)]
                     ).to(resolve_device(device))


def lm_unflat_params(w: torch.Tensor, model) -> dict:
    """The inverse of ``lm_flat_params``: the flat [d] vector as the
    reference's nested dict of numpy arrays, each stacked group [n, ...]
    again (for comparisons with the reference)."""
    layout = param_layout(model)
    layers: dict = {}
    out: dict = {}
    for (name, shape), part in zip(
            layout, torch.split(w.detach().cpu(), [s.numel() for _, s in layout])):
        a = part.reshape(shape).numpy()
        head, _, rest = name.partition(".")
        if head in _STACKED:
            i, _, path = rest.partition(".")
            layers.setdefault((head, path), {})[int(i)] = a
        else:
            _put(out, name, a)
    for (head, path), by_layer in layers.items():
        _put(out, f"{head}.{path}", np.stack([by_layer[i] for i in sorted(by_layer)]))
    return out


def _put(tree: dict, dotted: str, a) -> None:
    *parents, leaf = dotted.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = a


def mlp_params(params_np, hidden_layers: int,
               device: "str | torch.device" = DEFAULT_DEVICE) -> torch.Tensor:
    """The reference MLP's {"w0", "b0", ...} (numpy) as the port's flat [d]
    vector (models/mlp.py): w0, b0, w1, b1, ... each flattened row-major."""
    keys = [f"{kind}{i}" for i in range(hidden_layers + 1) for kind in ("w", "b")]
    if set(params_np) != set(keys):
        raise ValueError(f"MLP parameters {sorted(params_np)} do not fit "
                         f"{hidden_layers} hidden layers: expected {sorted(keys)}")
    return tensor(np.concatenate([np.asarray(params_np[k]).reshape(-1)
                                  for k in keys]), device)
