"""One federated round of each algorithm on a bf16 LM, run by the JAX
reference on the CPU: what the reference does with a bf16 model, which the
port refuses to train federated (core/lm.py::check_fl_config).

Config: the reduced smollm-135m with dtype bfloat16; K=2 clients of 4
documents of 64 tokens (make_lm_tokens, seed 0); eta 0.3; L=3; the
identity wire (repro.core.make_round_fn); the round from the reference's
init_state (key 0).

Printed, one line an algorithm and then one JSON object: whether the round
finished, the exception it raised if not (type and the first line of its
message), and, if it finished, the dtypes of the returned params' leaves
and the loss. On this tree FedSVRG and FedOSAA-SVRG raise TypeError in the
local trajectory's scan (its bf16 carry comes back f32: FLProblem.global_grad
takes tensordot of the f32 client weights with the bf16 gradients), and
FedAvg, SCAFFOLD and FedOSAA-AVG return f32 params (the same f32-weighted
tensordot in _aggregate).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_bf16_round.py
"""
from __future__ import annotations

import dataclasses
import json

import jax

from repro.configs import get_arch
from repro.core import AlgoHParams, init_state, make_round_fn
from repro.core.lm import make_lm_clients, make_lm_problem
from repro.data import make_lm_tokens
from repro.models.decoder import build_model

ARCH, K, DOCS, SEQ, ETA, L = "smollm-135m", 2, 4, 64, 0.3, 3
ALGOS = ("fedsvrg", "fedosaa_svrg", "fedavg", "scaffold", "fedosaa_avg")


def main() -> None:
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="bfloat16")
    toks = make_lm_tokens(K * DOCS, SEQ, cfg.vocab_size)
    prob = make_lm_problem(build_model(cfg), make_lm_clients(toks, K))
    hp = AlgoHParams(eta=ETA, local_epochs=L)
    out = {}
    for algo in ALGOS:
        state = init_state(prob, jax.random.PRNGKey(0), hp, None, algo)
        leaves_in = sorted({str(a.dtype) for a in jax.tree.leaves(state.params)})
        try:
            new, m = jax.jit(make_round_fn(algo, prob, hp))(state)
            jax.block_until_ready(new.params)
        except Exception as e:        # the finding: record what the round raised
            r = dict(finished=False, error=type(e).__name__,
                     message=str(e).splitlines()[0][:200])
        else:
            r = dict(finished=True, loss=float(m.loss),
                     params_dtypes=sorted({str(a.dtype)
                                           for a in jax.tree.leaves(new.params)}))
        r["params_dtypes_in"] = leaves_in
        out[algo] = r
        print(f"{algo}: {r}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
