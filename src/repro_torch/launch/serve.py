"""Batched serving: slot-based continuous batching over the decoder
(counterpart of repro/launch/serve.py).

A fixed pool of B slots shares one set of caches; requests are admitted
into free slots (their prompt fed as teacher-forced decode steps), generate
until EOS or max_tokens, and release their slot. Every step runs the full
[B, 1] batch, empty slots included, as in the reference.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b --device cpu

serves the reduced config, as the reference's serve.py; ``--full`` serves the
config at its published width (on the card: granite-moe-3b-a800m takes 6.7
GB of bf16 weights; llama4-scout-17b-a16e's 203 GB fit no one card).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import get_arch
from repro_torch.models.decoder import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [P] int32
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


class SlotServer:
    """B-slot decode server over ``model.decode_step``.

    The caches' bookkeeping is the reference's: one ring index per layer
    shared by all slots, pos = -1 for never-written entries, and an admitted
    slot's k/v/conv/ssm zeroed and its pos set to -1 (``reset_slot``)."""

    def __init__(self, model, batch_slots: int, cache_len: int,
                 eos_id: int | None = None,
                 device: "str | torch.device" = DEFAULT_DEVICE):
        self.model = model
        self.device = resolve_device(device)
        self.B = batch_slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.caches = model.init_caches(batch_slots, cache_len, self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self.slot_pending: list[list[int]] = [[] for _ in range(batch_slots)]
        self.steps = 0

    def admit(self, req: Request) -> bool:
        for s in range(self.B):
            if self.slot_req[s] is None:
                self.caches.reset_slot(s)
                self.slot_req[s] = req
                self.slot_pos[s] = 0
                self.slot_pending[s] = list(req.prompt)
                return True
        return False

    @torch.inference_mode()
    def step(self) -> None:
        """One global decode step: each active slot consumes its next pending
        (prompt) token or its last generated token."""
        tokens = np.zeros((self.B, 1), np.int32)
        pos = np.zeros((self.B, 1), np.int32)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.slot_pending[s]:
                tokens[s, 0] = self.slot_pending[s].pop(0)
            else:
                tokens[s, 0] = req.out[-1]
            pos[s, 0] = self.slot_pos[s]
        logits, self.caches = self.model.decode_step(
            self.caches, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device))
        nxt = torch.argmax(logits[:, : self.model.cfg.vocab_size], dim=-1)
        nxt = nxt.cpu().numpy().astype(np.int32)
        self.steps += 1
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            self.slot_pos[s] += 1
            if self.slot_pending[s]:
                continue                      # still feeding the prompt
            req.out.append(int(nxt[s]))
            hit_eos = self.eos_id is not None and req.out[-1] == self.eos_id
            if len(req.out) >= req.max_new_tokens or hit_eos or \
                    self.slot_pos[s] >= self.cache_len:
                req.done = True
                self.slot_req[s] = None

    def run(self, requests: list[Request]) -> dict:
        queue = list(requests)
        t0 = time.time()
        while queue or any(r is not None for r in self.slot_req):
            while queue and self.admit(queue[0]):
                queue.pop(0)
            self.step()
        dt = time.time() - t0
        toks = sum(len(r.out) for r in requests)
        return {"wall_s": dt, "tokens": toks, "steps": self.steps,
                "tok_per_s": toks / max(dt, 1e-9)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--full", action="store_true",
                    help="the config at its published width (default: reduced)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device, seed=0)
    rng = np.random.default_rng(0)
    reqs = [
        Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                args.new_tokens)
        for i in range(args.requests)
    ]
    srv = SlotServer(model, batch_slots=args.slots,
                     cache_len=args.prompt_len + args.new_tokens + 1,
                     device=args.device)
    stats = srv.run(reqs)
    print(f"served {len(reqs)} requests / {stats['tokens']} tokens in "
          f"{stats['wall_s']:.2f}s over {stats['steps']} steps "
          f"({stats['tok_per_s']:.1f} tok/s) on {srv.device}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out}")


if __name__ == "__main__":
    main()
