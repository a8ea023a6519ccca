"""Federated optimization over LM models (counterpart of repro/core/lm.py):
FedOSAA training of transformers and SSMs.

Clients hold token corpora; the FLProblem's loss is the model's next-token
cross entropy over the client's documents. Everything downstream (the
rounds, the AA step, the server's aggregation) is unchanged: the paper's
algorithm is architecture-agnostic.

The port's rounds work on one flat [d] parameter vector. Its layout is the
model's ``named_parameters()`` order (``param_layout``); the loss splits w
into views of that layout and runs ``Decoder.loss`` on them through
``torch.func.functional_call``, so ``torch.func.grad`` and ``vmap`` (one
point per client) differentiate the model in w. The LM has no linear
design, so the local trajectory is the autodiff one, as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.problem import (ClientBatch, FLProblem, StackedClients,
                                      stack_client_arrays)
from repro_torch.models.decoder import build_model, functional_loss

#: the parameter dtypes the AA kernels read (kernels/anderson/ops.py)
FL_DTYPES = ("float32", "float64")


def check_fl_config(cfg) -> None:
    """Raise NotImplementedError for a config the port does not train
    federated: a bf16 (or other non-f32/f64) model, and a model whose
    parameters would mix dtypes in the flat [d] vector (an f64 MoE model:
    its router is f32 whatever the model dtype, and ``torch.cat`` would
    promote it to f64 without a word)."""
    if cfg.dtype not in FL_DTYPES:
        raise NotImplementedError(
            f"{cfg.name}: federated training of a {cfg.dtype} model is not "
            "supported: the JAX reference cannot train one either (its rounds "
            "come back in f32, or raise in the SVRG trajectory's scan; "
            "scripts/reference_bf16_round.py), and the AA kernels read f32/f64 "
            "S, Y, w and g only. Train an f32 copy: "
            "dataclasses.replace(cfg, dtype='float32')")
    if cfg.family == "moe" and cfg.dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: mixed-dtype flat state (the MoE router is float32 in "
            f"a {cfg.dtype} model); the federated rounds hold one flat vector "
            "of one dtype. Train the float32 config")


def make_lm_clients(tokens: np.ndarray, num_clients: int,
                    docs_per_client: int | None = None,
                    device: "str | torch.device" = DEFAULT_DEVICE
                    ) -> StackedClients:
    """tokens: [n_docs, S] int32. IID split into K clients of
    ``docs_per_client`` documents (default n_docs // K); x keeps the int32
    ids, the labels are unused zeros."""
    per = docs_per_client or tokens.shape[0] // num_clients
    xs = [tokens[k * per:(k + 1) * per] for k in range(num_clients)]
    ys = [np.zeros((x.shape[0],), np.float32) for x in xs]
    return stack_client_arrays(xs, ys, device)


def param_layout(model) -> list[tuple[str, torch.Size]]:
    """(name, shape) of each parameter, in the order of the flat vector."""
    return [(name, p.shape) for name, p in model.named_parameters()]


def flatten_params(model) -> torch.Tensor:
    """The model's parameters as one flat [d] tensor (a copy)."""
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def unflatten(w: torch.Tensor, layout) -> dict:
    """Views of the flat w [d] in ``layout``: name → tensor of its shape."""
    sizes = [s.numel() for _, s in layout]
    return {name: part.view(shape) for (name, shape), part
            in zip(layout, torch.split(w, sizes))}


def make_lm_problem(model, clients: StackedClients) -> FLProblem:
    """The FLProblem of next-token cross entropy over ``clients``' documents
    (``make_lm_clients``), on the model's device. ``loss(w, batch)``: batch.x
    [n, S] token ids, batch.mask [n] document validity, broadcast to the
    loss mask [n, S]. ``init(generator)``: a freshly initialised model's
    parameters, flattened (``generator`` None: the model's own)."""
    cfg = model.cfg
    check_fl_config(cfg)
    if model.sh.mesh is not None:
        raise NotImplementedError(
            f"{cfg.name}: federated training of a model built under a sharding "
            "plan: the reference's FL round is replicated over the \"model\" "
            "axis (repro/core/sharded.py: no spec of the round names it), so "
            "its clients hold whole models. Build the model without a mesh; "
            "a plan trains through launch/steps.py::make_train_step")
    clients = clients.to(model.device, model.dtype)
    layout = param_layout(model)
    model_loss = functional_loss(model)

    def loss(w: torch.Tensor, batch: ClientBatch) -> torch.Tensor:
        mask = batch.mask[:, None].expand(batch.x.shape).to(torch.float32)
        return model_loss(unflatten(w, layout),
                          {"tokens": batch.x, "loss_mask": mask})

    def init(generator: "torch.Generator | None" = None) -> torch.Tensor:
        if generator is None:
            return flatten_params(model)
        return flatten_params(build_model(cfg, model.device, generator))

    return FLProblem(loss=loss, init=init, clients=clients)
