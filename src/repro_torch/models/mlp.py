"""Fully-connected ReLU MLP for the paper's NN experiments (Appendix D.5;
counterpart of repro/models/mlp.py).

MLP1 = one hidden layer of 256; MLP3 = three hidden layers of 256, the
paper's configurations, with softmax cross-entropy loss. The parameters are
one flat [d] vector: w0 [in, 256], b0 [256], w1, b1, ... in layer order,
each row-major (core/convert.py::mlp_params converts the reference's dict).
"""
from __future__ import annotations

import math

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.problem import ClientBatch, FLProblem, StackedClients


def make_mlp_problem(
    clients: StackedClients,
    hidden_layers: int = 1,
    hidden_dim: int = 256,
    num_classes: int = 10,
    weight_decay: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device: "str | torch.device" = DEFAULT_DEVICE,
) -> FLProblem:
    """The MLP's FLProblem over ``clients`` (x [K, n, in], integer labels y).
    ``init(generator)`` draws He-initialised weights (normal · sqrt(2/fan_in))
    and zero biases from ``generator`` (torch's numbers, not the
    reference's). ``problem.forward(w, x)`` gives the logits (mlp_accuracy)."""
    clients = clients.to(resolve_device(device), dtype)
    in_dim = clients.x.shape[-1]
    dims = [in_dim] + [hidden_dim] * hidden_layers + [num_classes]
    shapes = [s for din, dout in zip(dims[:-1], dims[1:])
              for s in ((din, dout), (dout,))]
    sizes = [math.prod(s) for s in shapes]

    def init(generator: "torch.Generator | None" = None) -> torch.Tensor:
        parts = []
        for din, dout in zip(dims[:-1], dims[1:]):
            w = torch.randn((din, dout), generator=generator, dtype=dtype,
                            device=clients.device) * math.sqrt(2.0 / din)
            parts += [w.reshape(-1), torch.zeros(dout, dtype=dtype,
                                                 device=clients.device)]
        return torch.cat(parts)

    def forward(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        p = [t.view(s) for t, s in zip(torch.split(w, sizes), shapes)]
        h = x
        for i in range(0, len(p) - 2, 2):
            h = torch.relu(h @ p[i] + p[i + 1])
        return h @ p[-2] + p[-1]

    def loss(w: torch.Tensor, batch: ClientBatch) -> torch.Tensor:
        logp = torch.log_softmax(forward(w, batch.x), dim=-1)
        nll = -logp.gather(-1, batch.y.long()[:, None])[:, 0]
        n = torch.clamp(batch.mask.sum(), min=1.0)
        l = (nll * batch.mask).sum() / n
        if weight_decay:
            l = l + 0.5 * weight_decay * torch.dot(w, w)
        return l

    problem = FLProblem(loss=loss, init=init, clients=clients)
    problem.__dict__["forward"] = forward    # for mlp_accuracy
    return problem


def mlp_accuracy(problem: FLProblem, params: torch.Tensor, x, y) -> float:
    """Share of the rows of x whose largest logit is their label y."""
    x = torch.as_tensor(x, dtype=params.dtype, device=params.device)
    y = torch.as_tensor(y, device=params.device)
    logits = problem.__dict__["forward"](params, x)
    return float((logits.argmax(-1) == y.long()).to(torch.float32).mean())
