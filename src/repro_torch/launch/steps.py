"""Step functions of the LM paths (counterpart of repro/launch/steps.py).

``make_train_step`` is the FedOSAA *local* step on an LM: SVRG-corrected
gradient descent (Algorithm 1 lines 10–14), forward, backward, correction
add, SGD update, on a dict of parameter tensors (the names of
``model.named_parameters()``). ``make_aa_step`` is the Anderson step once
per L local steps, on the flat parameter vector. ``make_prefill_step`` and
``make_serve_step`` are the serving paths; the port's model holds its
parameters, so those two take no ``params``.

Under a sharding plan (a model built with ``sh=plan.sharder()``), the
train step runs on the rank's parameter shards and returns the rank's new
shards, its shard of r and the global loss (models/decoder.py); the AA
step of a plan runs on the rank's flat shard in the layout of
core/convert.py::plan_flat_layout, whose first ``counted`` elements are the
ones this rank counts (sharding/specs.py::counted). Its Gram pass reads
only those; one all-reduce over the world sums the [m, m] Gram, the [m]
Yᵀg and ‖g‖²; the AA-step kernel then updates the rank's whole shard with
that ‖g‖² for θ. On a world of one it is the unsharded step, bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.func import grad_and_value

from repro_torch.core.anderson import AAConfig, multisecant_update
from repro_torch.kernels.anderson import ops as aa_ops
from repro_torch.kernels.anderson.ref import acc_dtype
from repro_torch.models.decoder import functional_loss


def make_train_step(model, eta: float = 1e-2):
    loss_fn = functional_loss(model)

    def train_step(params: dict, batch: dict, correction: dict):
        """One SVRG-corrected local GD step (Alg. 1 lines 12–13) on batch
        {"tokens", "loss_mask" (optional), "embeds" (optional)}: correction
        = ∇f(w^t) − ∇f_k(w^t) (precomputed, by name); the residual r =
        ∇f_k(w; ζ) + correction is returned for the AA history. Returns
        (new params, r, loss). Under a plan, ``params`` and ``correction``
        are the rank's shards and ``batch`` the global batch, of which the
        rank computes its rows."""
        grads, loss = grad_and_value(loss_fn)(params, batch)
        grads = model.sync_grads(grads, batch["tokens"].shape[0])
        r = {k: g + correction[k].to(g.dtype) for k, g in grads.items()}
        new = {k: (w - eta * r[k].to(w.dtype)).to(w.dtype) for k, w in params.items()}
        return new, r, loss

    return train_step


def make_aa_step(eta: float = 1e-2, history: int = 3, plan=None,
                 counted: int | None = None):
    """The Anderson step; with ``plan``, the rank's step of that plan on
    its flat shard, whose first ``counted`` elements it counts
    (core/convert.py::plan_flat_layout)."""
    cfg = AAConfig(tikhonov=1e-8, damping=1.0)
    if plan is not None and counted is None:
        raise ValueError("the AA step of a plan needs the rank's counted "
                         "prefix (core/convert.py::plan_flat_layout)")

    def aa_step(w, g, s_stack, y_stack):
        """One Anderson step over the flat parameters (Alg. 1 lines 15–18):
        w, g [d]; s_stack, y_stack [m, d]. Returns (w⁺ [d], θ)."""
        if plan is not None and dist.get_world_size() > 1:
            return _plan_step(w, g, s_stack, y_stack)
        new_w, stats = multisecant_update(w, g, s_stack[None], y_stack[None], eta,
                                          cfg, impl="auto")
        return new_w[0], stats.theta[0]

    def _plan_step(w, g, s_stack, y_stack):
        m, d = y_stack.shape
        a = acc_dtype(y_stack.dtype)
        yc = y_stack[:, :counted]
        gc = g[:counted]
        gram, yg = aa_ops.flat_gram((yc if counted == d else yc.contiguous())[None], gc)
        gn2 = torch.linalg.vector_norm(gc, dtype=torch.float64).square()
        buf = torch.cat([gram.reshape(-1).double(), yg.reshape(-1).double(),
                         gn2.reshape(1)])
        c = aa_step.counts.setdefault("all_reduce", {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += buf.numel() * buf.element_size()
        with torch.profiler.record_function("aa.all_reduce.world"):
            dist.all_reduce(buf)
        gram = buf[:m * m].to(a).reshape(1, m, m)
        yg = buf[m * m:m * m + m].to(a).reshape(1, m)
        new_w, _, theta, *_ = aa_ops.aa_step(
            w, g, s_stack[None], y_stack[None], gram, yg, eta,
            damping=cfg.damping, tikhonov=cfg.tikhonov,
            filter_rtol=cfg.filter_rtol, clip_rtol=cfg.clip_rtol,
            g_norm2=buf[-1:].to(a))
        return new_w[0], theta[0]

    #: the plan step's collectives: calls and the bytes each rank puts in
    aa_step.counts = {}
    return aa_step


def make_prefill_step(model, cache_len: int):
    def prefill_step(tokens, embeds=None):
        return model.prefill(tokens, embeds, cache_len=cache_len)

    return prefill_step


def make_serve_step(model):
    def serve_step(caches, tokens, pos):
        return model.decode_step(caches, tokens, pos)

    return serve_step
