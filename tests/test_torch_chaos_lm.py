"""The LM chaos executor of the port (``repro_torch.launch.train``'s
``TrainerExecutor`` and ``run_chaos_lm``, and ``chaos_train --lm``) against
the JAX package, on the CPU.

* The executor over a fixed schedule (m0 1, 3 steps, checkpoint, resize to
  2, 3 steps, restore, 2 steps) on the smoke stablelm-1.6b in float32,
  against a rehearsal of the same moves built from the reference's
  unsharded ``Trainer``, ``rescaled_config`` and ``CheckpointManager.restore``
  (the reference's own executor cannot run on this host's JAX: its (1, 1)
  debug mesh's axes are ``Explicit`` and its ``constrain`` asks for
  ``Auto`` ones), from the reference's weights: every loss within 1e-4
  relative, and the restore's wall time reported.
* ``run_chaos_lm`` on the crafted trace of
  ``tests/test_chaos.py::test_chaos_lm_loop_end_to_end`` with that test's
  gates (at least one resize, one mitigation, a restore; the last loss
  below the first by 0.5), and a second run for the same ``signature()``.
  Marked ``slow``, as the reference's test is: a run takes about 10 s alone
  on the CPU but 57-83 s under the tier-1 command's six workers (the
  controller's lasso refits are pure Python), past the 20 s a tier-1 case
  may take; ``chip_smoke.py``'s phase 30e runs the crafted trace with the
  same gates on the card.
* ``chaos_train --lm`` and the trainer CLI's ``--chaos`` run (a short
  generated trace).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.launch.train as ref_train
from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.configs import get_smoke_config as ref_smoke_config
from repro.training.trainer import rescaled_config as ref_rescaled_config
from repro_torch import chaos_train
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tree_from_numpy
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import TrainerExecutor, run_chaos_lm
from repro_torch.runtime.chaos import ChaosEvent, ChaosTrace

ARCH = "stablelm-1.6b"
SCHEDULE = [("steps", 3), ("checkpoint",), ("resize", 2), ("steps", 3), ("restore",),
            ("steps", 2)]


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _ref_trainer(m, ckpt_dir):
    """The reference executor's trainer at degree m (``_opts``, ``_build``,
    on no mesh), its lr scaled by m / m0 from the base config."""
    t = ref_train.Trainer(ref_train.TrainerOptions(
        arch=ARCH, smoke=True, steps=200, seq_len=32, global_batch=2 * m, ckpt_dir=ckpt_dir,
        ckpt_every=10 ** 9, seed=0, log_every=0))
    if m != 1:
        t.tcfg = ref_rescaled_config(t.tcfg, m / 1)
        t._step_fn = t._make_step()
    return t


def _ref_place(t):
    """The reference executor's ``_place_from_checkpoint`` without a mesh."""
    tree, meta = t.ckpt.restore(t.ckpt.latest_step())
    t.params = jax.tree.map(jnp.asarray, tree["params"])
    t.opt_state = jax.tree.map(jnp.asarray, tree["opt_state"])
    t.data.load_state_dict(meta["data_state"])
    t.step = int(meta["step"])


def test_executor_schedule_matches_a_reference_rehearsal(tmp_path, monkeypatch):
    """Both packages' smoke configs in float32 (each launcher's
    ``get_smoke_config`` patched)."""
    monkeypatch.setattr(ref_train, "get_smoke_config", lambda a: _f32(ref_smoke_config(a)))
    monkeypatch.setattr(train_cli, "get_smoke_config", lambda a: _f32(get_smoke_config(a)))
    ref = _ref_trainer(1, str(tmp_path / "ref"))
    start = jax.tree.map(np.asarray, (ref.params, ref.opt_state))
    ex = TrainerExecutor(ARCH, 1, ckpt_dir=str(tmp_path / "port"), device="cpu")
    try:
        ex.trainer.set_state(tree_from_numpy(start[0], "cpu"), tree_from_numpy(start[1], "cpu"))
        want, got = [], []
        for move in SCHEDULE:
            if move[0] == "steps":
                for _ in range(move[1]):
                    want.append(ref.train_some(1)["loss"])
                    got.append(ex.outer_step())
            elif move[0] == "checkpoint":
                ref._save(block=True)
                ref.ckpt.wait()
                ex.checkpoint()
            elif move[0] == "resize":
                ref = _ref_trainer(move[1], str(tmp_path / "ref"))
                _ref_place(ref)
                ex.resize(move[1])
            else:
                _ref_place(ref)
                ex.restore()
        assert ex.m == 2 and ex.trainer.opts.global_batch == 4
        assert ex.trainer.tcfg.learning_rate == ref.tcfg.learning_rate
        recovery = ex.last_recovery_s("restore")
        assert recovery is not None and recovery > 0
    finally:
        ex.close()
    assert isinstance(ref.ckpt, RefCheckpointManager)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-4 * abs(b), (got, want)


CRAFTED = ChaosTrace(seed=0, n_hosts=4, steps=70, events=[
    ChaosEvent(step=30, kind="straggler_on", host=0, magnitude=3.0, duration=8),
    ChaosEvent(step=50, kind="preempt", host=0)])


@pytest.fixture(scope="module")
def chaos_log(tmp_path_factory):
    return run_chaos_lm(ARCH, CRAFTED, str(tmp_path_factory.mktemp("chaos_lm")), device="cpu")


@pytest.mark.slow
def test_chaos_lm_loop_passes_the_reference_gates(chaos_log):
    log = chaos_log
    assert len(log.rows) == 70
    assert log.n_resizes() >= 1, "controller never resized"
    assert log.n_mitigations() >= 1, "straggler never mitigated"
    assert any(r.get("restore") for r in log.rows), "preemption not restored"
    losses = [r["objective"] for r in log.rows]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5
    assert log.meta["mode"] == "lm"


@pytest.mark.slow
def test_chaos_lm_loop_replays_to_the_same_signature(chaos_log, tmp_path):
    again = run_chaos_lm(ARCH, CRAFTED, str(tmp_path), device="cpu")
    assert again.signature() == chaos_log.signature()


def test_chaos_clis_run(tmp_path, capsys):
    log = chaos_train.main(["--lm", "--seed", "0", "--steps", "12", "--device", "cpu"])
    assert len(log.rows) == 12 and np.isfinite([r["objective"] for r in log.rows]).all()
    trace = tmp_path / "trace.json"
    out = tmp_path / "run.json"
    log = train_cli.main(["--chaos", str(trace), "--steps", "12", "--chaos-out", str(out),
                          "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")])
    assert trace.exists() and out.exists() and len(log.rows) == 12
    assert "[chaos] steps=12" in capsys.readouterr().out
