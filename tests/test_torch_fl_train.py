"""The two training launchers on the CPU: launch/fl_train.py's --out JSON
has the reference's keys (its loss curve is held against the reference's
in tests/test_torch_lm_train.py), then its options: the engine
(--round-chunk 2: the loop's curve bit for bit), telemetry
(--metrics-out), checkpoints (--checkpoint-dir, --resume auto continues
the straight run's curve), the distributed runtime at W = 1 (--runtime
sharded, dense and with --participation; --multi-pod on a world that is
not the production mesh's runs on the world it has), and the refusals (no
card, a bf16 config);
launch/train.py's centralized AdamW + WSD run and its checkpoint.
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.launch import fl_train, train

from torch_threads import one_torch_thread  # noqa: F401

SMALL = ["--arch", "smollm-135m", "--reduced", "--clients", "2",
         "--docs-per-client", "2", "--seq-len", "32", "--local-epochs", "2"]
CPU = ["--device", "cpu"]
ROOT = Path(__file__).resolve().parents[1]


def _run(tmp_path, name, *extra):
    out = tmp_path / f"{name}.json"
    res = fl_train.main(CPU + SMALL + ["--out", str(out), *extra])
    assert json.loads(out.read_text()).keys() == res.keys()
    return res


def reference_keys() -> set:
    """The keys of each algorithm's entry in the reference fl_train's --out
    JSON, read from its source (the ``results[algo] = {...}`` literal)."""
    src = (ROOT / "src" / "repro" / "launch" / "fl_train.py").read_text()
    block = src[src.index("results[algo] = {"):]
    return set(re.findall(r'^ {12}"(\w+)":', block[:block.index("\n        }\n")],
                          re.M))


def test_fl_train_writes_the_reference_keys(tmp_path):
    res = _run(tmp_path, "keys", "--rounds", "2", "--comm-codec", "int8",
               "--drop-rate", "0.25", "--deadline", "1.0", "--latency-scale", "1.0")
    entry = res["fedosaa_svrg"]
    assert entry.keys() == reference_keys() == {
        "loss_curve", "grad_norm_curve", "gram_cond_curve", "comm_bytes",
        "channel", "wall_s", "faults", "async"}
    assert entry["channel"].startswith("int8")
    assert entry["faults"]["drop_rate"] == 0.25 and len(entry["async"]["arrivals_curve"]) == 2
    assert np.isfinite(entry["loss_curve"]).all()


def test_fl_train_engine_metrics_and_baseline(tmp_path):
    loop = _run(tmp_path, "loop", "--rounds", "4", "--baseline", "fedsvrg",
                "--metrics-out", str(tmp_path / "m.jsonl"))
    chunked = _run(tmp_path, "chunked", "--rounds", "4", "--round-chunk", "2")
    assert loop.keys() == {"fedosaa_svrg", "fedsvrg"}
    assert chunked["fedosaa_svrg"]["loss_curve"] == loop["fedosaa_svrg"]["loss_curve"]
    for algo in loop:
        rows = [json.loads(line) for line in
                (tmp_path / f"m.{algo}.jsonl").read_text().splitlines()]
        assert rows[0]["kind"] == "header" and rows[-1]["kind"] == "footer"
        assert [r["loss"] for r in rows if r["kind"] == "round"] == \
            loop[algo]["loss_curve"]


def test_fl_train_checkpoint_resume_and_sharded(tmp_path):
    straight = _run(tmp_path, "straight", "--rounds", "3")["fedosaa_svrg"]
    ckpt = ["--checkpoint-dir", str(tmp_path / "ckpt"), "--checkpoint-every", "1",
            "--checkpoint-sync"]
    first = _run(tmp_path, "first", "--rounds", "2", *ckpt)["fedosaa_svrg"]
    resumed = _run(tmp_path, "resumed", "--rounds", "3", "--resume", "auto",
                   *ckpt)["fedosaa_svrg"]
    assert first["loss_curve"] + resumed["loss_curve"] == straight["loss_curve"]
    sharded = _run(tmp_path, "sharded", "--rounds", "3", "--runtime", "sharded")
    np.testing.assert_allclose(sharded["fedosaa_svrg"]["loss_curve"],
                               straight["loss_curve"], rtol=1e-12)
    assert not torch.distributed.is_initialized()


def test_fl_train_sharded_cohort(tmp_path):
    """--runtime sharded --participation 0.5 (a cohort of 2 of 4 clients,
    through the sharded plan and its row exchange in a world of one): the
    vmap run's loss curve within rel 1e-6."""
    cohort = ["--rounds", "3", "--clients", "4", "--participation", "0.5"]
    vmap = _run(tmp_path, "vmap_cohort", *cohort)["fedosaa_svrg"]
    sharded = _run(tmp_path, "sharded_cohort", *cohort, "--runtime",
                   "sharded")["fedosaa_svrg"]
    assert len(sharded["loss_curve"]) == 3
    np.testing.assert_allclose(sharded["loss_curve"], vmap["loss_curve"],
                               rtol=1e-6)
    assert not torch.distributed.is_initialized()


def test_fl_train_refusals(tmp_path, capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fl_train.main(SMALL + ["--rounds", "1"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
    # --multi-pod on a world of one (not the 2x16x16 mesh's 512 ranks):
    # the round runs on the world it has, as without the flag, and says so
    multi = fl_train.main(CPU + SMALL + ["--multi-pod", "--runtime", "sharded",
                                         "--rounds", "1"])
    plain = fl_train.main(CPU + SMALL + ["--runtime", "sharded", "--rounds", "1"])
    assert multi["fedosaa_svrg"]["loss_curve"] == plain["fedosaa_svrg"]["loss_curve"]
    assert "on mesh {'data': 1, 'model': 1}: 1 client shard(s)" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
    # the full config is bf16: refused before the model is built
    with pytest.raises(NotImplementedError,
                       match="the JAX reference cannot train one either"):
        fl_train.main(CPU + ["--arch", "smollm-135m", "--rounds", "1"])
    with pytest.raises(SystemExit):          # --resume auto names no directory
        fl_train.main(CPU + SMALL + ["--resume", "auto", "--rounds", "1"])


def test_train_runs_on_the_cpu(tmp_path):
    ckpt = str(tmp_path / "train_ckpt")
    res = train.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                      "--steps", "8", "--batch", "2", "--seq-len", "32",
                      "--schedule", "wsd", "--log-every", "4", "--ckpt", ckpt])
    loss = res["loss"]
    assert len(loss) == 8 and np.isfinite(loss).all() and loss[-1] < loss[0]
    back = restore_checkpoint(ckpt, res["params"])
    for k, v in res["params"].items():
        assert torch.equal(back[k], v), k
    sgd = train.main(["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq-len", "64",
                      "--optimizer", "sgd", "--schedule", "cosine"])
    assert np.isfinite(sgd["loss"]).all()
