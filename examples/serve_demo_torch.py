"""Serving demo on the PyTorch/CUDA port: batched prefill + greedy decode
with KV caches / SSM states for any assigned architecture (the port's
counterpart of examples/serve_demo.py).

  PYTHONPATH=src python examples/serve_demo_torch.py --arch mamba2-2.7b --new-tokens 16
  PYTHONPATH=src python examples/serve_demo_torch.py --arch qwen3-4b --full   # the card
  PYTHONPATH=src python examples/serve_demo_torch.py --device cpu

The reduced config by default, its published width with ``--full``.
Weights come from the port's seeded init; prompts from a numpy seed. On
the card the prefill runs the flash-attention and SSD kernels.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import get_arch
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.decoder import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def main(argv=None) -> list:
    """Print the prefill and decode times; return the first prompt's tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the config at its published width (default: reduced)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device, seed=0)

    B, P, N = args.batch, args.prompt_len, args.new_tokens
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)).to(device)
    prefill = make_prefill_step(model, P + N)
    t0 = time.time()
    last_logits, caches = prefill(prompts)
    _sync(device)
    print(f"prefill[{B}x{P}] in {time.time() - t0:.2f}s")

    dec = make_serve_step(model)
    tok = last_logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
    generated = [tok]
    t0 = time.time()
    for i in range(N - 1):
        pos = torch.full((B, 1), P + i, dtype=torch.int32, device=device)
        logits, caches = dec(caches, tok, pos)
        tok = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True).to(torch.int32)
        generated.append(tok)
    _sync(device)
    dt = time.time() - t0
    out = torch.cat(generated, dim=1).cpu()
    print(f"decoded {N - 1} tokens/seq in {dt:.2f}s "
          f"({B * (N - 1) / max(dt, 1e-9):.1f} tok/s batch throughput)")
    print("sample token ids:", out[0].tolist())
    return out[0].tolist()


if __name__ == "__main__":
    main()
