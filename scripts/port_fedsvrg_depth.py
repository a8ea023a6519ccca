"""FedSVRG at launch/fl_train.py's default step (eta 0.3) on smollm-135m at
its full width and full depth (30 layers; or LAYERS), the port alone, in
float32: the configuration of scripts/reference_fedsvrg_width.py (K=2
clients of 4 documents of 128 tokens, make_lm_tokens seed 0, L=1, ROUNDS
rounds) from the port's own initial params (build_model, seed 0), with
FedOSAA-SVRG beside it. The reference's side of that script does not run
here: it needs JAX, and the full depth is too large for a shared CPU.

Printed, as one JSON object: d, and each algorithm's loss and ‖Δw‖ per
round, with whether the loss rose in a round (divergence at this step).

    PYTHONPATH=src python scripts/port_fedsvrg_depth.py [LAYERS] [DEVICE]
"""
from __future__ import annotations

import dataclasses
import json
import sys

import torch

from repro_torch.configs import get_arch
from repro_torch.core import AlgoHParams, init_state, make_round_fn
from repro_torch.core.lm import make_lm_clients, make_lm_problem
from repro_torch.data import make_lm_tokens
from repro_torch.models.decoder import build_model

ARCH, K, DOCS, SEQ, ETA, L, ROUNDS = "smollm-135m", 2, 4, 128, 0.3, 1, 3
ALGOS = ("fedsvrg", "fedosaa_svrg")


def main() -> None:
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    device = sys.argv[2] if len(sys.argv) > 2 else "cuda"
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=layers,
                              dtype="float32")
    toks = make_lm_tokens(K * DOCS, SEQ, cfg.vocab_size)
    prob = make_lm_problem(build_model(cfg, device=device),
                           make_lm_clients(toks, K, device=device))
    out = {"layers": layers, "device": str(device), "eta": ETA}
    for algo in ALGOS:
        rf = make_round_fn(algo, prob, AlgoHParams(eta=ETA, local_epochs=L),
                           device=device)
        state = init_state(prob, device=device, algo=algo)
        out["d"] = int(state.params.numel())
        loss, dw = [], []
        for _ in range(ROUNDS):
            w_prev = state.params
            state, m = rf(state)
            loss.append(float(m.loss))
            dw.append(float(torch.linalg.vector_norm(state.params - w_prev)))
            del w_prev
        out[algo] = {"loss": loss, "dw": dw,
                     "loss_rose": any(b > a for a, b in zip(loss, loss[1:]))}
        del rf, state
    print(json.dumps(out))


if __name__ == "__main__":
    main()
