"""The trainer on a data mesh on the card: two ranks (one process each)
sharing one card over gloo, or a card each over nccl, the smoke
stablelm-1.6b in its bf16 config, 4 steps through K3 and K3-bwd at each
rank's rows (``repro_torch.launch.train.run_data_parallel``), against the
unmeshed trainer on the card from the same weights.

Marked ``gpu``: without a CUDA device each test skips from inside itself, so
every worker collects the same tests.  Run on the card with
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_fsdp_gpu.py``
(that machine has no JAX).

Tolerance: each step's loss within 1% of the unmeshed trainer's (as the
smoke trainers on the card against the CPU, chip_smoke.py's
TRAIN_LOSS_RTOL): both round every activation to bf16, and the mesh sums the
loss shares, the gradients and the norm in another order.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import pytest
import torch

from repro_torch.launch.train import Trainer, TrainerOptions, run_data_parallel

pytestmark = pytest.mark.gpu
OPTS = dict(arch="stablelm-1.6b", smoke=True, steps=10, seq_len=32, global_batch=4, log_every=0)
STEPS = 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_two_rank_step_on_the_card(card):
    single = Trainer(TrainerOptions(**OPTS))
    params, opt_state = single.whole_state()
    single.train_some(STEPS)
    reports = run_data_parallel(2, {"opts": OPTS, "steps": STEPS, "state": (params, opt_state)},
                                timeout_s=300)
    layers = single.cfg.n_layers
    for rep in reports:
        assert rep["device"].startswith("cuda")
        assert rep["backend"] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
        losses = [r["loss"] for r in rep["records"]]
        for got, (_, want) in zip(losses, single.history):
            assert abs(got - want) <= 1e-2 * abs(want), (losses, single.history)
        launches = {k: v for k, v in rep["launches"].items() if v}
        assert launches == {"flash_fwd": layers * STEPS, "flash_bwd_dq": layers * STEPS,
                            "flash_bwd_dkdv": layers * STEPS}, launches
    assert reports[0]["records"][-1]["loss"] == reports[1]["records"][-1]["loss"]
