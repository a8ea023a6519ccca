"""Step functions of the LM paths (counterpart of repro/launch/steps.py).

``make_train_step`` is the FedOSAA *local* step on an LM: SVRG-corrected
gradient descent (Algorithm 1 lines 10–14), forward, backward, correction
add, SGD update, on a dict of parameter tensors (the names of
``model.named_parameters()``). ``make_aa_step`` is the Anderson step once
per L local steps, on the flat parameter vector. ``make_prefill_step`` and
``make_serve_step`` are the serving paths; the port's model holds its
parameters, so those two take no ``params``.
"""
from __future__ import annotations

from torch.func import grad_and_value

from repro_torch.core.anderson import AAConfig, multisecant_update
from repro_torch.models.decoder import functional_loss


def make_train_step(model, eta: float = 1e-2):
    loss_fn = functional_loss(model)

    def train_step(params: dict, batch: dict, correction: dict):
        """One SVRG-corrected local GD step (Alg. 1 lines 12–13) on batch
        {"tokens", "loss_mask" (optional)}: correction = ∇f(w^t) − ∇f_k(w^t)
        (precomputed, by name); the residual r = ∇f_k(w; ζ) + correction is
        returned for the AA history. Returns (new params, r, loss)."""
        grads, loss = grad_and_value(loss_fn)(params, batch)
        r = {k: g + correction[k].to(g.dtype) for k, g in grads.items()}
        new = {k: (w - eta * r[k].to(w.dtype)).to(w.dtype) for k, w in params.items()}
        return new, r, loss

    return train_step


def make_aa_step(eta: float = 1e-2, history: int = 3):
    cfg = AAConfig(tikhonov=1e-8, damping=1.0)

    def aa_step(w, g, s_stack, y_stack):
        """One Anderson step over the flat parameters (Alg. 1 lines 15–18):
        w, g [d]; s_stack, y_stack [m, d]. Returns (w⁺ [d], θ)."""
        new_w, stats = multisecant_update(w, g, s_stack[None], y_stack[None], eta,
                                          cfg, impl="auto")
        return new_w[0], stats.theta[0]

    return aa_step


def make_prefill_step(model, cache_len: int):
    def prefill_step(tokens, embeds=None):
        return model.prefill(tokens, embeds, cache_len=cache_len)

    return prefill_step


def make_serve_step(model):
    def serve_step(caches, tokens, pos):
        return model.decode_step(caches, tokens, pos)

    return serve_step
