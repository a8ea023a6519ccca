"""Federated LM training driver (counterpart of repro/launch/fl_train.py):
FedOSAA (or any of the ten algorithms) over an assigned architecture.

  PYTHONPATH=src python -m repro_torch.launch.fl_train --arch smollm-135m \
      --reduced --algo fedosaa_svrg --rounds 20 --clients 4 [--device cpu]

Runs on the card unless ``--device cpu``. ``--reduced`` uses the
smoke-scale variant; without it the full config is built, whose default
dtype (bf16) neither the port nor the reference trains federated
(core/lm.py::check_fl_config): pass ``--dtype float32``. Compares against
``--baseline`` when given and writes the reference's JSON (``--out``).

Every flag of the reference maps onto the port's pieces: run_federated's
``chunk`` (``--round-chunk``), ``sinks`` and ``trace_capture`` (obs/),
``faults`` and ``async_cfg`` (robust/), ``checkpoint``, ``resume`` and
``checkpoint_fs`` (checkpoint/, robust/fs_faults.py), ``runtime`` and
``group`` (core/sharded.py). ``--aa-impl``/``--local-impl`` take the port's
names (auto, tree, kernel). ``--runtime sharded`` joins the process group
that ``torchrun`` describes in its environment (NCCL on the card, gloo on
the CPU); run alone, it is a world of one. ``--multi-pod`` names a TPU
mesh, which the port does not build.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.comm import make_channel
from repro_torch.configs import get_arch
from repro_torch.core import (AAConfig, AlgoHParams, resolve_cohort_size,
                              run_federated)
from repro_torch.core.lm import check_fl_config, make_lm_clients, make_lm_problem
from repro_torch.data import make_lm_tokens
from repro_torch.models.decoder import build_model

#: the FaultPlan fields the --out JSON records (the reference's)
FAULT_KEYS = ("seed", "drop_rate", "stale_rate", "byz_clients", "byz_mode",
              "dp_sigma", "latency_dist", "latency_scale", "latency_shape")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", default="",
                    help="parameter dtype (float32 or float64); default the "
                         "config's")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--algo", default="fedosaa_svrg")
    ap.add_argument("--baseline", default="")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--docs-per-client", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--eta", type=float, default=0.3)
    ap.add_argument("--local-epochs", type=int, default=5)
    ap.add_argument("--damping", type=float, default=1.0)
    ap.add_argument("--clip-rtol", type=float, default=0.0,
                    help="residual-clipped AA (AAConfig.clip_rtol): drop a "
                         "history column whose residual norm exceeds the "
                         "client's median by more than 1/clip_rtol; 0 = off")
    # -- fault injection (robust/) ----------------------------------------
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="per-round per-client probability the uplink never "
                         "lands (FaultPlan.drop_rate)")
    ap.add_argument("--stale-rate", type=float, default=0.0,
                    help="per-round per-client probability the upload is "
                         "computed against an aged anchor (FaultPlan.stale_rate)")
    ap.add_argument("--byz-clients", type=int, default=0,
                    help="number of (lowest-id) byzantine clients")
    ap.add_argument("--byz-mode", choices=("sign_flip", "noise", "history"),
                    default="sign_flip")
    ap.add_argument("--dp-sigma", type=float, default=0.0,
                    help="client-side Gaussian DP noise scale (post-codec)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="FaultPlan.seed: keys the whole injection stream")
    ap.add_argument("--latency-scale", type=float, default=0.0,
                    help="simulated per-client compute latency (0 = off)")
    ap.add_argument("--latency-shape", type=float, default=1.0)
    ap.add_argument("--latency-dist", choices=("lognormal", "pareto"),
                    default="lognormal")
    # -- deadline-gated aggregation (robust/async_agg.py) -----------------
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="deadline-gate the round close (AsyncConfig."
                         "deadline); 0 = the barriered round")
    ap.add_argument("--min-arrivals", type=int, default=0)
    ap.add_argument("--staleness-alpha", type=float, default=0.5)
    ap.add_argument("--participation", type=float, default=1.0,
                    help="share of the clients in a round: < 1 samples a "
                         "cohort each round")
    ap.add_argument("--cohort-size", type=int, default=0,
                    help="explicit cohort size C (wins over --participation); "
                         "0 = derive from --participation")
    ap.add_argument("--comm-codec", default="identity",
                    help="wire channel spec (comm/): identity | bf16 | "
                         "int8[:chunk] | topk[:ratio], optional +ef/+noef and "
                         "/<downlink-codec>")
    ap.add_argument("--runtime", choices=("vmap", "sharded"), default="vmap",
                    help="'sharded' splits the clients over the ranks of a "
                         "torch.distributed group (core/sharded.py)")
    ap.add_argument("--round-chunk", type=int, default=0,
                    help="run this many rounds a call through the engine "
                         "(core/engine.py; one CUDA graph on the card, one "
                         "host read a chunk). 0 = the per-round loop")
    ap.add_argument("--aa-impl", choices=("auto", "tree", "kernel"),
                    default="auto",
                    help="AA step (AlgoHParams.aa_impl): 'kernel' the Gram and "
                         "AA-step kernels, 'tree' plain tensor ops; auto = kernel")
    ap.add_argument("--local-impl", choices=("auto", "tree", "kernel"),
                    default="auto",
                    help="local trajectory (AlgoHParams.local_impl): the fused "
                         "kernel serves linear-design models only, so an LM "
                         "takes the autodiff path")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's two-pod TPU mesh; the port has no "
                         "TPU mesh and refuses it")
    ap.add_argument("--out", default="")
    # -- checkpointing (checkpoint/) ---------------------------------------
    ap.add_argument("--checkpoint-dir", default="",
                    help="checkpoint the whole ServerState under this directory")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--checkpoint-keep", type=int, default=3)
    ap.add_argument("--resume", default="none",
                    help="'auto': the newest complete checkpoint under "
                         "--checkpoint-dir; 'none': fresh; else a ckpt_* path")
    ap.add_argument("--checkpoint-sync", action="store_true",
                    help="save inline at the boundary, not on the writer thread")
    ap.add_argument("--inject-kill-save", type=int, default=0, metavar="N",
                    help="hard-exit (code 43) mid-write in the N-th save; 0 = off")
    # -- telemetry (obs/) --------------------------------------------------
    ap.add_argument("--metrics-out", default="",
                    help="stream per-round telemetry rows to this JSONL file")
    ap.add_argument("--metrics-stdout", type=int, default=0, metavar="N",
                    help="print every N-th telemetry row (0 = off)")
    ap.add_argument("--no-alarms", action="store_true",
                    help="no health monitors (attached with any metrics sink)")
    ap.add_argument("--trace-rounds", type=int, default=0, metavar="N",
                    help="a torch.profiler window over N rounds from --trace-start")
    ap.add_argument("--trace-start", type=int, default=0)
    ap.add_argument("--trace-dir", default="",
                    help="trace output dir (default <--out dir or .>/trace)")
    ap.add_argument("--trace-trigger", default="",
                    help="touching this file traces the next chunk")
    return ap


def _join_world(device: torch.device):
    """The default process group: the one already initialised, the one
    torchrun describes in its environment, or a world of one on an
    in-memory store. Returns (group, whether this call started it)."""
    if dist.is_initialized():
        return dist.group.WORLD, False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.group.WORLD, True


def main(argv=None) -> dict:
    """Run the algorithm (and the baseline) and return the results the
    ``--out`` JSON holds, by algorithm."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod builds the reference's two-pod TPU mesh; the port has "
            "no TPU-mesh tooling (ROADMAP.md item 9b)")
    dev = resolve_device(args.device)
    if args.runtime == "sharded" and dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    check_fl_config(cfg)

    model = build_model(cfg, device=dev, seed=0)
    toks = make_lm_tokens(args.clients * args.docs_per_client, args.seq_len,
                          cfg.vocab_size)
    clients = make_lm_clients(toks, args.clients, device=dev)
    problem = make_lm_problem(model, clients)

    hp = AlgoHParams(eta=args.eta, local_epochs=args.local_epochs,
                     participation=args.participation,
                     cohort_size=args.cohort_size or None,
                     aa=AAConfig(damping=args.damping, tikhonov=1e-8,
                                 clip_rtol=args.clip_rtol),
                     aa_impl=args.aa_impl, local_impl=args.local_impl)
    channel = make_channel(args.comm_codec)
    chunk = args.round_chunk if args.round_chunk > 0 else None

    from repro_torch.robust import AsyncConfig, FaultPlan
    faults = FaultPlan(
        seed=args.fault_seed, drop_rate=args.drop_rate,
        stale_rate=args.stale_rate, byz_clients=args.byz_clients,
        byz_mode=args.byz_mode, dp_sigma=args.dp_sigma,
        latency_dist=args.latency_dist, latency_scale=args.latency_scale,
        latency_shape=args.latency_shape)
    faults = faults if faults.active else None
    async_cfg = AsyncConfig(deadline=args.deadline,
                            min_arrivals=args.min_arrivals,
                            staleness_alpha=args.staleness_alpha)
    async_cfg = async_cfg if async_cfg.active else None
    if async_cfg is not None and (faults is None or not faults.simulates_latency):
        print("warning: --deadline without --latency-scale gates on all-zero "
              "latencies (every client on time)")

    ckpt_policy = ckpt_fs = None
    resume = args.resume if args.resume != "none" else None
    if args.checkpoint_dir:
        from repro_torch.checkpoint import CheckpointPolicy

        ckpt_policy = CheckpointPolicy(
            directory=args.checkpoint_dir, every=args.checkpoint_every,
            keep=args.checkpoint_keep,
            mode="sync" if args.checkpoint_sync else "async")
        if args.inject_kill_save > 0:
            from repro_torch.robust import FaultyFs, FSFaultPlan

            ckpt_fs = FaultyFs(FSFaultPlan(
                kill_at_save=args.inject_kill_save, kill_after_writes=1,
                kill_hard=True))
    elif resume == "auto":
        ap.error("--resume auto needs --checkpoint-dir")

    group, started = None, False
    if args.runtime == "sharded":
        group, started = _join_world(dev)
        shards = dist.get_world_size(group)
        if args.clients % shards:
            ap.error(f"--clients {args.clients} must divide over the {shards} "
                     f"client shards of the process group; use --clients "
                     f"{shards} or a multiple")
        csize = resolve_cohort_size(hp, args.clients)
        if csize is not None and csize % shards:
            ap.error(f"the cohort of {csize} clients (--participation, "
                     f"--cohort-size) must divide over the {shards} client "
                     f"shards of the process group; pick a multiple of "
                     f"{shards}")
        print(f"sharded runtime over {shards} rank(s) "
              f"({dist.get_backend(group)})")

    algos = [args.algo] + ([args.baseline] if args.baseline else [])

    def build_sinks(algo: str):
        """Per-algo telemetry sinks and trace capture (obs/), fresh per run
        so each algo gets its own JSONL file and alarm state."""
        from repro_torch.obs import (AlarmMonitor, JsonlSink, StdoutSink,
                                     TraceCapture, TraceConfig)

        sinks = []
        if args.metrics_out:
            base, ext = os.path.splitext(args.metrics_out)
            path = (args.metrics_out if len(algos) == 1
                    else f"{base}.{algo}{ext or '.jsonl'}")
            sinks.append(JsonlSink(path))
        if args.metrics_stdout:
            sinks.append(StdoutSink(every=args.metrics_stdout))
        if sinks and not args.no_alarms:
            sinks.append(AlarmMonitor())
        tc = None
        if args.trace_rounds > 0 or args.trace_trigger:
            trace_dir = args.trace_dir or os.path.join(
                os.path.dirname(args.out) or ".", "trace")
            tc = TraceCapture(TraceConfig(
                trace_dir=trace_dir, start_round=args.trace_start,
                num_rounds=args.trace_rounds,
                trigger_file=args.trace_trigger or None))
        return sinks, tc

    results = {}
    try:
        for algo in algos:
            sinks, trace_capture = build_sinks(algo)
            pol = ckpt_policy
            if pol is not None and len(algos) > 1:
                # per-algo subdirectory: the manifests carry per-algo config
                # fingerprints, so one directory would refuse the second's
                pol = dataclasses.replace(pol, directory=os.path.join(pol.directory, algo))
            t0 = time.time()
            h = run_federated(problem, algo, hp, args.rounds, device=dev,
                              channel=channel, chunk=chunk, sinks=sinks,
                              trace_capture=trace_capture, faults=faults,
                              async_cfg=async_cfg, checkpoint=pol,
                              resume=resume, checkpoint_fs=ckpt_fs,
                              runtime=args.runtime, group=group)
            results[algo] = {
                "loss_curve": [float(v) for v in h.loss],
                "grad_norm_curve": [float(v) for v in h.grad_norm],
                "gram_cond_curve": [float(v) for v in h.gram_cond_max],
                "comm_bytes": float(h.comm_bytes[-1]) if len(h.comm_bytes) else 0.0,
                "channel": h.channel,
                "wall_s": time.time() - t0,
                # what was injected travels with the artifact
                "faults": None if faults is None else {
                    k: getattr(faults, k) for k in FAULT_KEYS},
                "async": (None if async_cfg is None else {
                    "deadline": async_cfg.deadline,
                    "min_arrivals": async_cfg.min_arrivals,
                    "staleness_alpha": async_cfg.staleness_alpha,
                    "arrivals_curve": [float(v) for v in h.arrivals],
                    "staleness_max_curve": [float(v) for v in h.staleness_max],
                }),
            }
            if len(h.loss):
                print(f"{algo}: loss {h.loss[0]:.4f} -> {h.loss[-1]:.4f} "
                      f"|g| {h.grad_norm[-1]:.2e} "
                      f"wire {h.comm_bytes[-1] / 2**20:.2f}MiB[{h.channel}] "
                      f"({results[algo]['wall_s']:.0f}s)")
    finally:
        if started:
            dist.destroy_process_group()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
