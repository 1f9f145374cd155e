"""The port stands alone: it loads no JAX and nothing of the JAX package, and
its entry points never drop to the CPU on their own."""
import _torch_threads  # sets this worker's torch threads
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro") or n.startswith("jax"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    for module in ("repro_torch.quickstart", "repro_torch.convert",
                   "repro_torch.optim.simcluster", "repro_torch.kernels.sdca.ops",
                   "repro_torch.kernels.sdca.build", "repro_torch.core.hemingway",
                   "repro_torch.kernels.flash_attention.ops",
                   "repro_torch.kernels.flash_decode.ops", "repro_torch.kernels.ssm_scan.ops",
                   "repro_torch.models.mamba", "repro_torch.models.model",
                   "repro_torch.models.mla", "repro_torch.models.moe",
                   "repro_torch.models.blocks", "repro_torch.serve.cache",
                   "repro_torch.serve.engine", "repro_torch.serve.planner",
                   "repro_torch.telemetry.tracker", "repro_torch.launch.serve",
                   "repro_torch.kernels.flash_decode.ref", "repro_torch.models.runtime",
                   "repro_torch.kernels.tune", "repro_torch.kernels.tune.cache",
                   "repro_torch.kernels.tune.roofline", "repro_torch.kernels.tune.sweep",
                   "repro_torch.kernels.tune.telemetry", "repro_torch.kernels.tune.__main__",
                   "repro_torch.optim.sgd", "repro_torch.optim.lbfgs",
                   "repro_torch.kernels.local_sgd.ops", "repro_torch.kernels.local_sgd.build",
                   "repro_torch.kernels.local_sgd.ref", "repro_torch.telemetry.refit",
                   "repro_torch.runtime.chaos", "repro_torch.runtime.failures",
                   "repro_torch.runtime.straggler", "repro_torch.chaos_train",
                   "repro_torch.training.optimizers", "repro_torch.training.trainer",
                   "repro_torch.training.tree", "repro_torch.data.pipeline",
                   "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
                   "repro_torch.launch.train", "repro_torch.kernels.flash_attention.ref",
                   "repro_torch.telemetry.trace", "repro_torch.telemetry.trace.spans",
                   "repro_torch.telemetry.trace.export", "repro_torch.telemetry.trace.attribution",
                   "repro_torch.telemetry.trace.slo", "repro_torch.telemetry.__main__",
                   "repro_torch.serve.router", "repro_torch.serve.migrate",
                   "repro_torch.dist", "repro_torch.dist.partitioning",
                   "repro_torch.dist.treeutil", "repro_torch.dist.collectives",
                   "repro_torch.models.param", "repro_torch.serve.sharding",
                   "repro_torch.launch.mesh", "repro_torch.runtime.elastic",
                   "repro_torch.compression", "repro_torch.compression.gradient",
                   "repro_torch.fleet", "repro_torch.fleet.cluster",
                   "repro_torch.fleet.workloads", "repro_torch.fleet.scheduler",
                   "repro_torch.fleet.simulate", "repro_torch.launch.fleet",
                   "repro_torch.fleet_day", "repro_torch.launch.inputs",
                   "repro_torch.launch.dryrun", "repro_torch.dist.op_costs",
                   "repro_torch.dist.op_analysis", "repro_torch.train_100m",
                   "repro_torch.elastic_train", "repro_torch.autotune_lm"):
        assert module in report["imported"]


def test_chip_smoke_imports_no_jax_and_no_reference():
    """chip_smoke.py names neither package in its imports."""
    source = (ROOT / "chip_smoke.py").read_text()
    for line in source.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "jaxlib", "repro"), line


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    from repro_torch import (autotune_lm, chaos_train, elastic_train, fleet_day, quickstart,
                             train_100m)
    from repro_torch.configs import cocoa_mnist
    from repro_torch.convert import cocoa_state_from_numpy, problem_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh, serve, train
    from repro_torch.models.model import LM
    from repro_torch.kernels import tune
    from repro_torch.kernels.tune import __main__ as tune_cli
    from repro_torch.optim import make_mnist_svm
    from repro_torch.runtime.chaos import run_chaos_sim
    from repro_torch.serve import ServeEngine

    X = np.zeros((4, 2), np.float32)
    y = np.ones(4, np.float32)
    calls = [
        lambda: make_mnist_svm(cocoa_mnist.smoke_config()),
        lambda: problem_from_numpy(X, y, 1e-3),
        lambda: cocoa_state_from_numpy(X[None], y[None], y[None], X[0]),
        lambda: quickstart.main(["--n", "64", "--d", "4", "--ms", "1"]),
        lambda: LM(get_smoke_config("qwen3-14b")),
        lambda: ServeEngine("qwen3-14b"),
        lambda: ServeEngine("falcon-mamba-7b"),
        lambda: LM(get_smoke_config("deepseek-v2-236b")),
        lambda: ServeEngine("deepseek-v2-236b"),
        lambda: serve.main(["--arch", "deepseek-v2-236b", "--smoke", "--continuous"]),
        lambda: serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--continuous"]),
        lambda: serve.main(["--smoke", "--continuous"]),
        lambda: serve.main(["--smoke", "--router", "--replicas", "2", "--migrate-at", "3"]),
        lambda: serve.main(["--smoke", "--trace", str(tmp_path / "t.json")]),
        lambda: serve.main(["--smoke", "--batch", "2", "--prompt-len", "4", "--gen", "2"]),
        lambda: serve.Server("qwen3-14b").generate(np.zeros((1, 4), np.int32), 2),
        lambda: train.main(["--smoke", "--steps", "1"]),
        lambda: train.Trainer(train.TrainerOptions(smoke=True, steps=1)),
        lambda: train.main(["--smoke", "--steps", "1", "--compression", "int8"]),
        lambda: train.main(["--chaos", str(tmp_path / "trace.json"), "--steps", "4"]),
        lambda: train.TrainerExecutor("stablelm-1.6b", 1, ckpt_dir=str(tmp_path / "ex")),
        lambda: chaos_train.main(["--lm", "--steps", "4"]),
        lambda: tune_cli.main(["--preset", "smoke", "--families", "sdca", "--cache",
                                str(tmp_path / "t.json")]),
        lambda: tune.ensure("sdca", tune.SWEEP_SHAPES["smoke"]["sdca"],
                            cache=tune.ConfigCache(None)),
        lambda: chaos_train.main(["--seed", "0", "--steps", "20"]),
        lambda: run_chaos_sim(0, steps=20),
        lambda: mesh.rank_device(1),
        lambda: mesh.init_distributed(0, 1, str(tmp_path / "rendezvous")),
        lambda: fleet_day.main(["--real-convex", "--no-replay"]),
        lambda: fleet_day.main(["--scenario", "drift", "--real-convex", "--no-replay"]),
        lambda: train_100m.main(["--steps", "1"]),
        lambda: elastic_train.main([]),
        lambda: autotune_lm.main(["--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_explicit_cpu_runs_without_a_card(no_card, tmp_path, capsys):
    from repro_torch import chaos_train, fleet_day, quickstart
    from repro_torch.runtime.chaos import ChaosRunLog, run_chaos_sim

    result = quickstart.main(["--device", "cpu", "--n", "256", "--d", "8",
                              "--ms", "1", "2", "4", "--iters", "12",
                              "--ref-iters", "30"])
    assert result["fastest_to_epsilon"][1] in (1, 2, 4)
    assert result["best_within_budget"][1] in (1, 2, 4)
    assert set(result["t_iter"]) == {1, 2, 4}

    log = chaos_train.main(["--device", "cpu", "--seed", "1", "--steps", "40",
                            "--out", str(tmp_path / "run.json")])
    out = capsys.readouterr().out
    assert "steps=40 " in out and "replay: identical" in out
    assert ChaosRunLog.load(tmp_path / "run.json").signature() == log.signature()
    assert run_chaos_sim(1, steps=40, device="cpu").signature() == log.signature()

    log = fleet_day.main(["--real-convex", "--device", "cpu", "--no-replay"])
    out = capsys.readouterr().out
    assert "acceptance: all serve SLOs met" in out
    assert any("obj" in r["jobs"]["job_sweep"] for r in log.rows)
    log = fleet_day.main(["--scenario", "migrate", "--real-convex", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "golden: matches" in out
    assert {r["jobs"]["job_mig"]["m"] for r in log.rows if "obj" in r["jobs"]["job_mig"]} \
        - {0} == {2, 4}  # 0 once done


def test_fleet_cli_makes_no_cuda_call(monkeypatch, capsys, tmp_path):
    """The fleet, its CLI and its scenarios touch no device: any CUDA call
    (a query, an initialisation, a tensor on the card) raises here."""
    from repro_torch.launch import fleet

    def refuse(*args, **kwargs):
        raise AssertionError("the fleet CLI made a CUDA call")

    for name in ("is_available", "device_count", "init", "_lazy_init", "synchronize",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    spans = tmp_path / "spans.json"
    assert fleet.main(["--scenario", "migrate", "--measured", "--slo",
                       "--spans", str(spans)]) == 0
    assert fleet.main(["--ticks", "24"]) == 0
    out = capsys.readouterr().out
    assert out.count("replay: identical") == 2 and spans.exists()


def test_torch_threads_are_the_workers_share():
    """Under xdist each worker runs torch on its share of the cores
    (tests/_torch_threads.py); the helper's rule, and its effect in a fresh
    interpreter told it is one of 4 workers."""
    cores = os.cpu_count() or 1
    assert _torch_threads.worker_threads({}) is None
    assert _torch_threads.worker_threads({"PYTEST_XDIST_WORKER_COUNT": "6"}) == max(1, cores // 6)
    assert _torch_threads.worker_threads({"PYTEST_XDIST_WORKER_COUNT": str(4 * cores)}) == 1
    if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
        assert torch.get_num_threads() == _torch_threads.worker_threads()
    env = dict(os.environ, PYTEST_XDIST_WORKER_COUNT="4")
    out = subprocess.run([sys.executable, "-c", "import _torch_threads, torch; "
                          "print(torch.get_num_threads())"], env=env,
                         cwd=ROOT / "tests", capture_output=True, text=True, timeout=120,
                         check=True)
    assert int(out.stdout.split()[-1]) == max(1, cores // 4)
