"""Centralized LM trainer (counterpart of repro/launch/train.py; the
non-federated baseline substrate): AdamW or SGD with momentum, the
constant, cosine and WSD schedules, global-norm gradient clipping,
checkpointing.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --reduced \
      --steps 100 --batch 4 --seq-len 256 --schedule wsd [--device cpu]

Runs on the card unless ``--device cpu``; ``--dtype`` overrides the
config's parameter dtype (full configs default to bf16). The step is
eager torch: ``torch.func.grad_and_value`` of ``Decoder.loss`` over a dict
of parameter tensors, then the optimizer's functional update.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import make_lm_tokens
from repro_torch.models.decoder import build_model, functional_loss
from repro_torch.optim import adamw, clip_by_global_norm, constant, cosine, sgd, wsd


def main(argv=None) -> dict:
    """Train and return {"loss": [per step], "ms_per_step": wall after the
    first step, "first_step_ms", "params": the final parameters}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine", choices=["constant", "cosine", "wsd"])
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dtype", default="",
                    help="parameter dtype (float32, float64, bfloat16); default "
                         "the config's")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    model = build_model(cfg, device=dev, seed=0)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}

    sched = {
        "constant": lambda: constant(args.lr),
        "cosine": lambda: cosine(args.lr, args.steps, warmup=args.steps // 20),
        "wsd": lambda: wsd(args.lr, args.steps),
    }[args.schedule]()
    opt = adamw(sched) if args.optimizer == "adamw" else sgd(sched, momentum=0.9)
    opt_state = opt.init(params)

    toks = make_lm_tokens(args.batch * 64, args.seq_len, cfg.vocab_size)
    loss_fn = functional_loss(model)

    def step(params, opt_state, batch):
        grads, loss = grad_and_value(loss_fn)(params, batch)
        grads = clip_by_global_norm(grads, args.clip)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    losses = []
    t0 = time.perf_counter()
    t_first = 0.0
    for i in range(args.steps):
        idx = (np.arange(args.batch) + i * args.batch) % toks.shape[0]
        batch = {"tokens": torch.from_numpy(toks[idx]).to(dev)}
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss.detach())
        if i == 0:
            float(loss)                     # the first step ends on the device
            t_first = time.perf_counter() - t0
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(loss):.4f}  "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    curve = torch.stack(losses).cpu().tolist()
    wall = time.perf_counter() - t0
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")
    return {"loss": curve, "first_step_ms": 1e3 * t_first,
            "ms_per_step": 1e3 * (wall - t_first) / max(args.steps - 1, 1),
            "params": params}


if __name__ == "__main__":
    main()
