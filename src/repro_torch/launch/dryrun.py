"""The pod-mesh dry-run (counterpart of repro/launch/dryrun.py).

Runs every (architecture × input shape) step of the reference's production
meshes — 16 × 16 = 256 ranks, or 2 × 16 × 16 = 512 with ``--multi-pod`` —
without a card and without memory: one process stands in for rank 0 of a
fake ``torch.distributed`` world of that size (the "fake" backend, whose
collectives move nothing), builds that rank's model on the ``meta`` device
under the plan (sharding/specs.py), and runs its step on meta tensors:
``train_4k`` as the plan's train step and AA step (history 3),
``prefill_32k``, and ``decode_32k`` / ``long_500k`` on the rank's caches.
It records the reference's fields for the rank:

* ``memory.argument_bytes`` / ``output_bytes``: the bytes of the step's
  inputs and outputs that the rank holds (its parameter shards, its rows
  of the batch, its caches);
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  matmul family (its convention, not XLA's cost analysis);
* ``collectives``: the Sharder's tallies, forward and backward: calls and
  the bytes each rank puts in, by kind and by mesh axis (the reference
  sums the result shapes of the compiled HLO's collectives);
* ``aa_step``: the AA step's flops and collectives.

What only a compiled program has (``bytes_accessed``, ``temp_bytes``,
``peak_bytes``) is null. The kernel wrappers run their plain versions on
meta tensors.

``--fl-round`` runs core/sharded.py's round on the world the command runs
in (a gloo or NCCL world started by ``torchrun`` or
core/sharded.py::spawn_world, or a world of one), since the reference's
round is replicated over "model": its client shards are the world's ranks,
and the record names the mesh the run stands for. The workload is the
reference's: 64 clients of ``synthetic_small`` logistic regression, n =
2048, η 0.5, L = 3; the Newton family n = 8192, η 1, L = 10.

Usage (results under ``--out-dir``, by default build/dryrun/):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --fl-round fedosaa_svrg \
      --fl-rounds 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, get_shape
from repro_torch.core.convert import plan_flat_layout
from repro_torch.kernels.anderson.ref import acc_dtype
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs_io import (batch_specs_for, cache_len_for,
                                         caches_shape, correction_shape,
                                         effective_cfg, params_shape)
from repro_torch.launch.steps import (make_aa_step, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.decoder import build_model
from repro_torch.sharding.specs import batch_axis, make_plan

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun")
#: the AA step's history in the train pairs (the reference's)
AA_HISTORY = 3
#: Newton-family dry-run workload (the reference's: n/K >= d for full-rank
#: local Hessians)
NEWTON_ALGOS = ("giant", "newton_gmres", "dane")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def fake_world(world: int) -> None:
    """Stand in for rank 0 of a world of ``world`` ranks (the fake
    backend: its collectives move nothing). Joins it once per process."""
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_backend() != "fake":
            raise ValueError(f"this process is in a {dist.get_backend()} world of "
                             f"{dist.get_world_size()} ranks; the dry-run needs "
                             f"the fake world of {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def nbytes(tree) -> int:
    """The bytes of every tensor in a nested dict / list / tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return nbytes(tree.tree) if hasattr(tree, "tree") else 0


def collectives(counts: dict) -> dict:
    """A Sharder's (or the AA step's) tallies in the reference's keys:
    bytes and ``<kind>_count`` calls by kind ("all-reduce", ...), and
    ``by_axis``."""
    out = {}
    for kind, c in sorted(counts.items()):
        key = kind.replace("_", "-")
        out[key] = c["bytes"]
        out[key + "_count"] = c["calls"]
        if c.get("by_axis"):
            out.setdefault("by_axis", {})[key] = c["by_axis"]
    return out


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               include_aa: bool = True) -> dict:
    """Rank 0's step of one (arch × input shape) pair on the production
    mesh, on meta tensors (module docstring)."""
    t0 = time.time()
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = get_shape(shape_name)
    plan = make_plan(effective_cfg(get_arch(arch), shape), mesh, multi_pod=multi_pod)
    cfg = plan.cfg
    sh = plan.sharder()
    model = build_model(cfg, device="meta", sh=sh)
    params = params_shape(model)
    B = shape.global_batch
    rows = sh.batch_rows(B)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": mesh_name(multi_pod), "chips": 512 if multi_pod else 256,
        "regime": plan.regime,
        "attn_variant": "sliding_window" if cfg.sliding_window else
                        ("none" if not cfg.num_heads else "full_causal"),
        "batch_axis": str(batch_axis(plan, B)),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    flops = FlopCounterMode(display=False)
    if shape.kind == "train":
        batch = batch_specs_for(cfg, shape)["batch"]
        corr = correction_shape(params)
        with flops:
            new, r, loss = make_train_step(model)(params, batch, corr)
        args = 2 * nbytes(params) + nbytes({k: v[rows] for k, v in batch.items()})
        outs = nbytes([new, r, loss])
    elif shape.kind == "prefill":
        io = batch_specs_for(cfg, shape)
        with flops:
            out = make_prefill_step(model, cache_len_for(cfg, shape))(
                io["tokens"], io.get("embeds"))
        args = nbytes(params) + nbytes({k: v[rows] for k, v in io.items()})
        outs = nbytes(out)
    else:
        C = cache_len_for(cfg, shape)
        caches = caches_shape(model, B, C)
        io = batch_specs_for(cfg, shape)
        args = nbytes(params) + nbytes(caches) + nbytes({k: v[rows] for k, v in io.items()})
        with flops:
            out = make_serve_step(model)(caches, io["tokens"], io["pos"])
        outs = nbytes(out)
        result["cache_len"] = C
    result["trace_s"] = round(time.time() - t0, 1)
    result["flops"] = float(flops.get_total_flops())
    result["bytes_accessed"] = None
    result["memory"] = {"argument_bytes": args, "output_bytes": outs,
                        "temp_bytes": None, "peak_bytes": None}
    result["collectives"] = collectives(sh.counts)

    if shape.kind == "train" and include_aa:
        layout, counted = plan_flat_layout(params, plan, mesh.rank)
        d = sum(s.numel() for _, s in layout)
        a = acc_dtype(getattr(torch, cfg.dtype))
        w, g = (torch.empty(d, dtype=a, device="meta") for _ in range(2))
        s, y = (torch.empty(AA_HISTORY, d, dtype=a, device="meta") for _ in range(2))
        aa = make_aa_step(history=AA_HISTORY, plan=plan, counted=counted)
        aa_flops = FlopCounterMode(display=False)
        with aa_flops:
            aa(w, g, s, y)
        result["aa_step"] = {"flops": float(aa_flops.get_total_flops()),
                             "bytes_accessed": None,
                             "collectives": collectives(aa.counts)}
    return result


def dryrun_fl_round(algo: str, multi_pod: bool = False, num_clients: int = 64,
                    n: int | None = None, comm_codec: str = "identity",
                    rounds: int = 1, round_chunk: int = 1, aa_impl: str = "auto",
                    local_impl: str = "auto", cohort_size: int | None = None,
                    clip_rtol: float = 0.0, drop_rate: float = 0.0,
                    stale_rate: float = 0.0, byz_clients: int = 0,
                    byz_mode: str = "sign_flip", dp_sigma: float = 0.0,
                    fault_seed: int = 0, checkpoint_dir: str = "",
                    checkpoint_every: int = 10, checkpoint_keep: int = 3,
                    resume: str = "none",
                    device: "str | torch.device" = DEFAULT_DEVICE,
                    dtype: str = "float32", draws=None) -> dict:
    """The reference's FL-round dry-run, on the world this process is in
    (module docstring): every rank calls it with the same arguments; each
    returns the same record. As the reference's: the per-round loop of the
    sharded round function, or with ``round_chunk > 1`` the engine
    (core/server.py::run_federated, as with faults or checkpoints).
    ``comm_bytes`` is the last round's. ``dtype``: the problem's (the
    reference's dry-run runs float32; float64 is the dtype parity is judged
    in, ROADMAP.md). ``draws`` (the loop only): round t
    -> its draws for all K clients ({tag: [K, ...]}, as
    ``round.draw_specs`` names them), of which each rank feeds its rows;
    None: the round's own."""
    from repro_torch.comm import make_channel
    from repro_torch.core import AAConfig, AlgoHParams, init_state, run_federated
    from repro_torch.core.server import solve_reference
    from repro_torch.core.sharded import make_sharded_round_fn
    from repro_torch.data import make_binary_classification, partition
    from repro_torch.models.logreg import make_logreg_problem
    from repro_torch.robust import FaultPlan

    t0 = time.time()
    dev = resolve_device(device)
    started = False
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        started = True
    try:
        round_chunk = max(1, min(round_chunk, rounds))
        aa = AAConfig(clip_rtol=clip_rtol)
        if algo in NEWTON_ALGOS:
            n = 8192 if n is None else n
            hp = AlgoHParams(eta=1.0, local_epochs=10, aa=aa, aa_impl=aa_impl,
                             local_impl=local_impl, cohort_size=cohort_size)
        else:
            n = max(2048, 8 * num_clients) if n is None else n
            hp = AlgoHParams(eta=0.5, local_epochs=3, aa=aa, aa_impl=aa_impl,
                             local_impl=local_impl, cohort_size=cohort_size)
        X, y = make_binary_classification("synthetic_small", n=n, seed=0)
        problem = make_logreg_problem(
            partition(X, y, num_clients, "iid", seed=0, device=dev), 1e-3,
            dtype=getattr(torch, dtype), device=dev)
        faults = FaultPlan(seed=fault_seed, drop_rate=drop_rate,
                           stale_rate=stale_rate, byz_clients=byz_clients,
                           byz_mode=byz_mode, dp_sigma=dp_sigma)
        faults = faults if faults.active else None
        ckpt = None
        if checkpoint_dir:
            from repro_torch.checkpoint import CheckpointPolicy
            ckpt = CheckpointPolicy(directory=checkpoint_dir, every=checkpoint_every,
                                    keep=checkpoint_keep)
        elif resume == "auto":
            raise ValueError('resume="auto" needs checkpoint_dir')
        channel = make_channel(comm_codec)
        w_star = solve_reference(problem, iters=50)
        t1 = time.time()
        if round_chunk > 1 or faults or ckpt or resume != "none":
            if draws is not None:
                raise ValueError("draws feed the per-round loop only")
            h = run_federated(problem, algo, hp, rounds, w_star=w_star, device=dev,
                              channel=channel,
                              chunk=round_chunk if round_chunk > 1 else None,
                              faults=faults, checkpoint=ckpt,
                              resume=None if resume == "none" else resume,
                              runtime="sharded")
            if not len(h.loss):
                raise ValueError(f"resume landed at or past the {rounds}-round "
                                 "budget: nothing left to run (raise --fl-rounds)")
            start = int(h.rounds[0])
            losses, rel_errors = [float(v) for v in h.loss], [float(v) for v in h.rel_error]
            conds = [float(v) for v in h.gram_cond_max]
            last_bytes = float(np.diff(h.comm_bytes, prepend=0.0)[-1])
        else:
            start, losses, rel_errors, conds = 0, [], [], []
            round_fn = make_sharded_round_fn(algo, problem, hp, channel=channel,
                                             device=dev)
            state = init_state(round_fn.rank_problem, None, dev, channel, algo, hp)
            rows = round_fn.shard.rows
            w_norm = max(float(torch.linalg.vector_norm(w_star)), 1e-30)
            for t in range(rounds):
                fed = None if draws is None else {
                    name: v[rows].to(dev) for name, v in draws(t).items()}
                state, m = round_fn(state, fed)
                losses.append(float(m.loss))
                conds.append(float(m.gram_cond_max))
                rel_errors.append(float(torch.linalg.vector_norm(
                    state.params - w_star)) / w_norm)
            last_bytes = float(m.comm_bytes)
        return {
            "fl_round": algo,
            "mesh": mesh_name(multi_pod),
            "chips": 512 if multi_pod else 256,
            "client_shards": dist.get_world_size(),
            "backend": dist.get_backend(),
            "device": str(dev),
            "dtype": dtype,
            "num_clients": num_clients,
            "cohort_size": cohort_size,
            "channel": channel.name,
            "round_chunk": round_chunk,
            "clip_rtol": clip_rtol,
            "faults": None if faults is None else {
                "seed": faults.seed, "drop_rate": faults.drop_rate,
                "stale_rate": faults.stale_rate, "byz_clients": faults.byz_clients,
                "byz_mode": faults.byz_mode, "dp_sigma": faults.dp_sigma},
            "aa_impl": aa_impl,
            "local_impl": local_impl,
            "start_round": start,
            "setup_s": round(t1 - t0, 2),
            "run_s": round((time.time() - t1) / len(losses), 4),
            "loss": losses[-1],
            "loss_curve": losses,
            "rel_error": rel_errors[-1],
            "rel_error_curve": rel_errors,
            "gram_cond_curve": conds,
            "comm_bytes": last_bytes,
        }
    finally:
        if started:
            dist.destroy_process_group()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="")
    ap.add_argument("--shape", type=str, default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-aa", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where the JSON records go (default build/dryrun/)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="with --fl-round: cuda (the default; raises without a "
                         "card) or cpu")
    ap.add_argument("--fl-round", type=str, default="",
                    help="run the sharded FL round of this algorithm ('all' = "
                         "the two headline FedOSAA variants)")
    ap.add_argument("--comm-codec", type=str, default="identity",
                    help="with --fl-round: the wire channel (comm/)")
    ap.add_argument("--fl-rounds", type=int, default=1)
    ap.add_argument("--fl-dtype", choices=("float32", "float64"), default="float32",
                    help="with --fl-round: the problem's dtype (the reference's "
                         "is float32)")
    ap.add_argument("--round-chunk", type=int, default=1,
                    help="with --fl-round: rounds a call of the engine "
                         "(core/engine.py); 1 = the per-round loop")
    ap.add_argument("--fl-clients", type=int, default=64)
    ap.add_argument("--cohort-size", type=int, default=0)
    ap.add_argument("--clip-rtol", type=float, default=0.0)
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--stale-rate", type=float, default=0.0)
    ap.add_argument("--byz-clients", type=int, default=0)
    ap.add_argument("--byz-mode", choices=("sign_flip", "noise", "history"),
                    default="sign_flip")
    ap.add_argument("--dp-sigma", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--aa-impl", choices=("auto", "tree", "kernel"), default="auto")
    ap.add_argument("--local-impl", choices=("auto", "tree", "kernel"),
                    default="auto")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--checkpoint-keep", type=int, default=3)
    ap.add_argument("--resume", default="none",
                    help="with --fl-round: 'auto', 'none' or a ckpt_* path")
    return ap


def _fl_tag(args, algo: str) -> str:
    """The record's file name: the reference's tag scheme."""
    codec = ("" if args.comm_codec == "identity"
             else f"{args.comm_codec.replace('/', '-').replace(':', '')}__")
    parts = []
    chunk = max(1, min(args.round_chunk, args.fl_rounds))
    if args.cohort_size:
        parts.append(f"cohort{args.cohort_size}-of-{args.fl_clients}")
    elif chunk > 1:
        parts.append(f"chunk{chunk}")
    for flag, text in ((args.clip_rtol, f"clip{args.clip_rtol:g}"),
                       (args.drop_rate, f"drop{args.drop_rate:g}"),
                       (args.stale_rate, f"stale{args.stale_rate:g}"),
                       (args.byz_clients,
                        f"byz{args.byz_clients}-{args.byz_mode.replace('_', '')}"),
                       (args.dp_sigma, f"dp{args.dp_sigma:g}"),
                       (args.aa_impl != "auto", args.aa_impl),
                       (args.local_impl != "auto", f"local-{args.local_impl}")):
        if flag:
            parts.append(text)
    engine = f"{'+'.join(parts)}__" if parts else ""
    dtype = "" if args.fl_dtype == "float32" else f"{args.fl_dtype}__"
    return f"fl_round__{algo}__{codec}{engine}{dtype}{mesh_name(args.multi_pod)}"


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.fl_round:
        algos = (["fedosaa_svrg", "fedosaa_scaffold"] if args.fl_round == "all"
                 else [args.fl_round])
        for algo in algos:
            tag = _fl_tag(args, algo)
            res = dryrun_fl_round(
                algo, args.multi_pod, num_clients=args.fl_clients,
                comm_codec=args.comm_codec, rounds=args.fl_rounds,
                round_chunk=args.round_chunk, aa_impl=args.aa_impl,
                local_impl=args.local_impl,
                cohort_size=args.cohort_size or None, clip_rtol=args.clip_rtol,
                drop_rate=args.drop_rate, stale_rate=args.stale_rate,
                byz_clients=args.byz_clients, byz_mode=args.byz_mode,
                dp_sigma=args.dp_sigma, fault_seed=args.fault_seed,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                checkpoint_keep=args.checkpoint_keep, resume=args.resume,
                device=args.device, dtype=args.fl_dtype)
            if not dist.is_initialized() or dist.get_rank() == 0:
                with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
            print(f"OK   {tag}: shards={res['client_shards']} loss={res['loss']:.6f} "
                  f"relerr={res['rel_error']:.3e} bytes={res['comm_bytes']:g}")
    else:
        combos = ([(a, s) for a in ARCHS for s in INPUT_SHAPES] if args.all
                  else [(args.arch, args.shape)])
        for arch, shape in combos:
            tag = f"{arch}__{shape}__{mesh_name(args.multi_pod)}"
            res = dryrun_one(arch, shape, args.multi_pod, include_aa=not args.no_aa)
            with open(os.path.join(args.out_dir, tag + ".json"), "w") as f:
                json.dump(res, f, indent=1)
            coll = sum(v for k, v in res["collectives"].items()
                       if k != "by_axis" and not k.endswith("_count"))
            print(f"OK   {tag}: {res['trace_s']}s flops={res['flops']:.3e} "
                  f"args={res['memory']['argument_bytes']} coll={coll / 2**30:.3f}GiB")
    print("all dry-runs passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
