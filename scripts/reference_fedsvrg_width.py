"""FedSVRG at launch/fl_train.py's default step (eta 0.3) on smollm-135m at
its full width (d_model 576, 9 heads, d_ff 1536, the 49,152-token
vocabulary) with its depth cut to LAYERS of 30, the JAX reference against
the port, on the CPU in float32: K=2 clients of 4 documents of 128 tokens
(make_lm_tokens, seed 0), L=1, ROUNDS rounds from the reference's initial
params (its run_federated's init, key 0), each side on its own state, both
through their tree/autodiff paths.

Printed, as one JSON object: d, both loss curves, ‖Δw‖ of each round on
each side, and the relative gaps (the loss at rel 1e-3, ‖Δw‖ at rel 1e-3
is the gate the port's reduced-width test holds, tests/test_torch_lm_train.py).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_fedsvrg_width.py [LAYERS]
"""
from __future__ import annotations

import dataclasses
import json
import sys

import jax
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import AlgoHParams as RefHP
from repro.core import init_state as ref_init_state
from repro.core import make_round_fn as ref_make_round_fn
from repro.core.lm import make_lm_clients as ref_lm_clients
from repro.core.lm import make_lm_problem as ref_lm_problem
from repro.data import make_lm_tokens
from repro.models.decoder import build_model as ref_build_model
from repro_torch.configs import get_arch
from repro_torch.core import AlgoHParams, convert, make_round_fn
from repro_torch.core import init_state
from repro_torch.core.lm import make_lm_clients, make_lm_problem
from repro_torch.models.decoder import build_model

ARCH, K, DOCS, SEQ, ETA, L, ROUNDS = "smollm-135m", 2, 4, 128, 0.3, 1, 3
ALGO = "fedsvrg"


def jit0(fn, *args):
    """``fn`` compiled at XLA's backend optimization level 0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def main() -> None:
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    torch.set_num_threads(4)
    jcfg = dataclasses.replace(ref_get_arch(ARCH), num_layers=layers,
                               dtype="float32")
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=layers,
                              dtype="float32")
    toks = make_lm_tokens(K * DOCS, SEQ, jcfg.vocab_size)
    jp = ref_lm_problem(ref_build_model(jcfg), ref_lm_clients(toks, K))
    model = build_model(cfg, device="cpu")
    pp = make_lm_problem(model, make_lm_clients(toks, K, device="cpu"))
    jhp = RefHP(eta=ETA, local_epochs=L, aa_impl="tree", local_impl="tree")
    key = jax.random.PRNGKey(0)
    st = jit0(lambda k: ref_init_state(jp, k, jhp, None, ALGO), key)(key)
    rf = jit0(ref_make_round_fn(ALGO, jp, jhp), st)
    w0 = convert.lm_flat_params(jax.tree.map(np.asarray, st.params), model,
                                "cpu")
    ours = make_round_fn(ALGO, pp, AlgoHParams(eta=ETA, local_epochs=L),
                         device="cpu")
    ps = init_state(pp, device="cpu", algo=ALGO)._replace(params=w0)
    out = {"layers": layers, "d": int(w0.numel()),
           "ref": {"loss": [], "dw": []}, "port": {"loss": [], "dw": []}}
    for _ in range(ROUNDS):
        prev = convert.lm_flat_params(jax.tree.map(np.asarray, st.params),
                                      model, "cpu")
        st, m = rf(st)
        now = convert.lm_flat_params(jax.tree.map(np.asarray, st.params),
                                     model, "cpu")
        out["ref"]["loss"].append(float(m.loss))
        out["ref"]["dw"].append(float(torch.linalg.vector_norm(now - prev)))
        w_prev = ps.params
        ps, pm = ours(ps)
        out["port"]["loss"].append(float(pm.loss))
        out["port"]["dw"].append(float(torch.linalg.vector_norm(
            ps.params - w_prev)))
    for k in ("loss", "dw"):
        out[f"{k}_rel_gap"] = [abs(a - b) / abs(b) for a, b in zip(
            out["port"][k], out["ref"][k])]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
