"""The reference's expert-parallel MoE (repro/models/layers.py::
moe_sharded) on a split batch, against its unsharded ``moe`` on each batch
row alone: granite-moe-3b-a800m's reduced config padded for 2 model ranks,
the inputs of tests/test_torch_train_plan.py (drawn by the port: params
seed 0, a batch of 2 rows of 64 tokens), float32, on the CPU.

The model's loss (and aux loss) on (data, model) meshes of 4 host devices
((2, 2), (2, 1), (1, 2); a jax.sharding.Mesh), on the (2, 2) mesh also
with the dispatch repaired (tests/test_torch_train_plan.py::
REPAIRED_MOE_SHARDED: the dropped assignments' sentinel writes go to a slot
of their own instead of expert 0's last slot), and the positions whose
logits differ from the unsharded model's on that row by more than 1e-3.
The mean of the rows' losses is what the port's (2, 2) train step is held
to (its row-wise stand-in).

Printed, as one JSON object.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_moe_sharded.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import test_torch_train_plan as T  # noqa: E402

ARCH = "granite-moe-3b-a800m"

#: run with 4 host devices: reads inputs.npz, prints JSON
MESHES = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
""" + T.REPAIRED_MOE_SHARDED + r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models.decoder import build_model
from repro.sharding.specs import batch_axis, make_plan, param_specs
inp = dict(np.load(sys.argv[1]))
def nest(prefix):
    out = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = out
            *parents, leaf = k[len(prefix):].split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = jnp.asarray(v)
    return out
params, batch = nest("params/"), nest("batch/")
tokens = batch["tokens"]
cfg = make_plan(get_arch(sys.argv[2]).reduced(),
                jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))).cfg
plain = build_model(cfg)
rows = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(tokens.shape[0])]
out = {"capacity_factor": cfg.capacity_factor, "experts": cfg.eff_experts,
       "experts_per_token": cfg.experts_per_token,
       "unsharded_rows": [float(jax.jit(plain.loss)(params, r)) for r in rows],
       "unsharded_row_aux": [float(jax.jit(plain.forward)(params, r["tokens"])[1]) for r in rows],
       "unsharded_whole_batch": float(jax.jit(plain.loss)(params, batch))}
row_logits = [np.asarray(jax.jit(plain.forward)(params, r["tokens"])[0][0]) for r in rows]
as_is = _lyr.moe_sharded
for label, D, M, fn in (("2x2", 2, 2, as_is), ("2x2_repaired", 2, 2, repaired_moe_sharded()),
                        ("2x1", 2, 1, as_is), ("1x2", 1, 2, as_is)):
    _lyr.moe_sharded = fn
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:D * M]).reshape(D, M), ("data", "model"))
    plan = make_plan(get_arch(sys.argv[2]).reduced(), mesh)
    jm = build_model(plan.cfg, plan.sharder())
    p_shard = jax.tree.map(lambda s: NamedSharding(mesh, s), param_specs(params, plan),
                           is_leaf=lambda x: isinstance(x, P))
    ba = batch_axis(plan, tokens.shape[0])
    b_shard = jax.tree.map(lambda x: NamedSharding(mesh, P(ba, *([None] * (x.ndim - 1)))), batch)
    logits, aux = jax.jit(jm.forward, in_shardings=(p_shard, b_shard["tokens"]))(params, tokens)
    logits = np.asarray(logits)
    off = {i: np.nonzero(np.abs(logits[i] - row_logits[i]).max(-1) > 1e-3)[0].tolist()
           for i in range(tokens.shape[0])} if D == 2 else None
    out[label] = {"loss": float(jax.jit(jm.loss, in_shardings=(p_shard, b_shard))(params, batch)),
                  "aux": float(aux), "positions_off_the_rows_model": off}
print(json.dumps(out))
"""


def main() -> None:
    from repro_torch.configs import get_arch

    cfg = T.reduced(get_arch, ARCH).padded(2)
    inp = T.case_inputs(cfg, True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "inputs.npz")
        np.savez(path, **{f"{n}/{k}": v for n in ("params", "correction", "batch")
                          for k, v in T._leaves(inp[n])})
        res = subprocess.run([sys.executable, "-c", MESHES, path, ARCH], env=T._env(),
                             cwd=str(ROOT), capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise SystemExit(res.stderr[-4000:])
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["row_mean"] = float(np.mean(out["unsharded_rows"]))
    out["row_mean_aux"] = float(np.mean(out["unsharded_row_aux"]))
    out["2x2_rel_to_row_mean"] = abs(out["2x2"]["loss"] - out["row_mean"]) / out["row_mean"]
    out["2x2_repaired_rel_to_row_mean"] = (abs(out["2x2_repaired"]["loss"] - out["row_mean"])
                                           / out["row_mean"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
