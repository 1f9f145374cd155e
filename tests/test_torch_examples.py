"""The example trainers as entry points of the port (``repro_torch.train_100m``,
``repro_torch.elastic_train``, ``repro_torch.autotune_lm``) against the JAX
package's examples on the CPU.

Every trainer here runs in float32 (both packages' configs replaced, the
smoke configs through each launcher's ``get_smoke_config``, as
tests/test_torch_chaos_lm.py patches them), and the port starts from the
reference's parameters and optimizer state (``tree_from_numpy``,
``Trainer.set_state``).  The reference's trainers draw their state once per
(config, seed) in this module: ``Trainer._build_state`` is wrapped to keep
the state it drew and give the same values to the next trainer of that
config and seed (a reference trainer's draw takes seconds; the values are
the reference's own).

* ``train_100m``: ``config_100m(s)`` field for field and ``param_count()``
  at s = 0.25 and 1; 4 steps at scale 0.25 (seq 64) against a rehearsal of
  the example's swap (``examples/train_100m.py:56-68``): every loss within
  1e-4 relative (the same float32 arithmetic summed in other orders, over
  four Adam steps).
* ``elastic_train``: ``run(...)`` against a rehearsal of the example's loop
  (``examples/elastic_train.py:25-66``) on the reference's ``Trainer``: a
  schedule of chunks of 2 that reaches the controller (the reference
  resizes, asserted), and the defaults shortened only in steps (no
  decision).  Held: every loss within 1e-4 relative, the same decisions
  at the same steps, the failure at step 17 and its restore, and the
  reference's quirks: (a) steps are built only where a trainer is built
  or restarts after the failure, with the total_steps then current; (b)
  ``trainer.opts`` comes from the first trainer's options (global batch
  2, the injector, which fires in the resized trainer) while the data
  keeps its batch; (c) every ``run()`` restores the newest checkpoint
  and saves at its end: the same saves and restores, step for step.
* ``autotune_lm``: its CLI's run (8 steps at each m), then ``plan``'s
  result on the curves and step times it measured against the reference's
  classes on the same inputs: the same m and active features, R^2 and the
  predicted time within 1e-9 relative (both numpy, the same operations);
  infeasibility raises; ``loss_curve`` at m = 1 and 2 for 4 steps against
  the example's ``loss_curve``, within 1e-4 relative.
* Each CLI's ``--device cpu`` run prints its lines.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.launch.train as ref_train
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import AdaptiveController as RefController
from repro.core import CombinedModel as RefCombined
from repro.core import ConvergenceData as RefData
from repro.core import ConvergenceModel as RefConvergence
from repro.core import ErnestModel as RefErnest
from repro.core import Planner as RefPlanner
from repro.optim.simcluster import CommModel as RefCommModel
from repro.runtime.failures import FailureInjector as RefInjector
from repro_torch import autotune_lm, elastic_train, train_100m
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tree_from_numpy
from repro_torch.launch import train as port_train

ROOT = Path(__file__).resolve().parents[1]
ARCH = "stablelm-1.6b"
RTOL = 1e-4


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF_100M = _example("train_100m")
REF_AUTOTUNE = _example("autotune_lm")
_DRAWN = {}  # (config, seed) -> the reference's drawn params, axes and opt_state (numpy)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(autouse=True)
def float32_and_drawn_once(monkeypatch):
    """Both launchers' smoke configs in float32; the reference's draws kept
    per (config, seed)."""
    monkeypatch.setattr(ref_train, "get_smoke_config", lambda a: _f32(ref_smoke_config(a)))
    monkeypatch.setattr(port_train, "get_smoke_config", lambda a: _f32(get_smoke_config(a)))
    draw = ref_train.Trainer._build_state

    def build_state(self):
        key = (self.cfg, self.opts.seed)
        if key not in _DRAWN:
            draw(self)
            _DRAWN[key] = jax.tree.map(np.asarray, (self.params, self.param_axes,
                                                    self.opt_state))
        params, axes, opt_state = _DRAWN[key]
        self.params = jax.tree.map(jnp.asarray, params)
        self.param_axes = axes
        self.opt_state = jax.tree.map(jnp.asarray, opt_state)
        self.comp_state = None
        self.step = 0

    monkeypatch.setattr(ref_train.Trainer, "_build_state", build_state)


def _state_of(ref_trainer):
    """A reference trainer's (params, opt_state) on the port's CPU."""
    return (tree_from_numpy(jax.tree.map(np.asarray, ref_trainer.params), "cpu"),
            tree_from_numpy(jax.tree.map(np.asarray, ref_trainer.opt_state), "cpu"))


def _close(got, want):
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        assert abs(a - b) <= RTOL * abs(b), (got, want)


# -------------------------------------------------------------- elastic_train
def _rehearse_elastic(td, *, target_gap=0.05, m_options=(1, 2, 4), refit_every=15,
                      min_observations=20, reshard_cost_s=1.0, step_budget=120, chunk=20,
                      fail_at=17, ckpt_every=10):
    """``examples/elastic_train.py:25-66`` with its constants as arguments;
    returns what ``elastic_train.run`` returns, and the first trainer's
    drawn state."""
    sys_model = RefErnest().fit(np.array([1, 2, 4, 8]), np.full(4, 1.0),
                                np.array([0.40, 0.22, 0.13, 0.09]))
    ctrl = RefController(sys_model, target_gap=target_gap, p_star=0.0,
                         m_options=list(m_options), refit_every=refit_every,
                         min_observations=min_observations, reshard_cost_s=reshard_cost_s)
    out = {"history": [], "decisions": [], "resizes": [], "timings": []}
    m = 1
    opts = ref_train.TrainerOptions(arch=ARCH, smoke=True, steps=40, seq_len=64,
                                    global_batch=2 * m, log_every=0, ckpt_dir=td,
                                    ckpt_every=ckpt_every,
                                    failure_injector=RefInjector.at(fail_at))
    trainer = ref_train.Trainer(opts)
    start = _state_of(trainer)
    while trainer.step < step_budget:
        trainer.opts = opts
        n = min(chunk, step_budget - trainer.step)
        trainer.opts = opts.__class__(**{**opts.__dict__, "steps": trainer.step + n})
        trainer.tcfg = trainer.tcfg.__class__(**{**trainer.tcfg.__dict__,
                                                 "total_steps": step_budget})
        seen = len(trainer.history)
        trainer.run()
        out["history"] += trainer.history[seen:]
        loss = trainer.history[-1][1]
        decision = ctrl.observe(trainer.step, m, loss)
        if decision is not None:
            out["decisions"].append(dict(dataclasses.asdict(decision), step=trainer.step, m=m))
        if decision and decision.resize:
            out["resizes"].append((trainer.step, m, decision.target_m))
            m = decision.target_m
            trainer._save(block=True)
            out["timings"] += trainer.ckpt.timings
            new_opts = ref_train.TrainerOptions(
                arch=ARCH, smoke=True, steps=step_budget, seq_len=64, global_batch=2 * m,
                log_every=0, ckpt_dir=td, ckpt_every=ckpt_every)
            trainer = ref_train.Trainer(new_opts)
            trainer._maybe_restore()
    out["timings"] += trainer.ckpt.timings
    out.update(failures=sorted(opts.failure_injector.fired), final_step=trainer.step, m=m,
               trainer=trainer)
    return out, start


def _record_built_steps(monkeypatch, cls, built):
    """Each step a trainer of ``cls`` builds: (its step then, the
    total_steps of the config it closes over)."""
    make = cls._make_step

    def recording(self):
        built.append((self.step, self.tcfg.total_steps))
        return make(self)

    monkeypatch.setattr(cls, "_make_step", recording)


def _elastic_parity(tmp_path, monkeypatch, capsys, **schedule):
    ref_built, port_built = [], []
    _record_built_steps(monkeypatch, ref_train.Trainer, ref_built)
    _record_built_steps(monkeypatch, port_train.Trainer, port_built)
    want, start = _rehearse_elastic(str(tmp_path / "ref"), **schedule)
    capsys.readouterr()
    got = elastic_train.run(cfg=_f32(get_smoke_config(ARCH)), device="cpu", state=start,
                            ckpt_dir=str(tmp_path / "port"), **schedule)
    out = capsys.readouterr().out
    _close([x for _, x in got["history"]], [x for _, x in want["history"]])
    assert [s for s, _ in got["history"]] == [s for s, _ in want["history"]]
    key = ("step", "m", "resize", "target_m")
    assert [[d[k] for k in key] for d in got["decisions"]] == \
        [[d[k] for k in key] for d in want["decisions"]]
    assert got["resizes"] == want["resizes"]
    assert got["failures"] == want["failures"] == [17]
    assert out.count("[failure] simulated node_lost at step 17") == 1
    # (a): steps built only at a trainer's build and at the restart
    assert port_built == ref_built
    # (c): every run() restores the newest checkpoint and saves at its end
    assert [(t["op"], t["step"]) for t in got["timings"]] == \
        [(t["op"], t["step"]) for t in want["timings"]]
    # (b): the first trainer's options, the data's own batch
    for result in (got, want):
        trainer = result["trainer"]
        assert trainer.opts.global_batch == 2
        assert trainer.opts.failure_injector.fired == {17}
        assert trainer.data.global_batch == 2 * result["m"]
    assert got["final_step"] == want["final_step"] == schedule.get("step_budget", 120)
    n = len(want["resizes"])
    assert out.splitlines()[-1].endswith(f"resize decisions: {n}")
    assert out.count("[elastic] step ") == n
    return got, want, ref_built


def test_elastic_train_resizes_as_the_example_does(tmp_path, monkeypatch, capsys):
    """Chunks of 4 to 18 steps, the controller's one refit at its 3rd
    observation (step 12); at a target gap of 3.0 the fit reaches it and
    moves m 1 -> 4 (the reference predicts ~35 s against ~103 s); the
    failure at 17 falls in the resized trainer, whose options are the first
    trainer's, and restarts it from the checkpoint at 16 that ended its
    chunk (no checkpoint between the chunks' own: ckpt_every 100)."""
    got, want, built = _elastic_parity(
        tmp_path, monkeypatch, capsys, step_budget=18, chunk=4, min_observations=3,
        refit_every=3, target_gap=3.0, ckpt_every=100)
    assert want["resizes"] == [(12, 1, 4)]
    assert built == [(0, 40), (0, 18), (16, 18)]


def test_elastic_train_defaults_decide_nothing(tmp_path, monkeypatch, capsys):
    """The example's constants over 18 steps, one chunk: the failure at 17
    restarts from the checkpoint at 10, the controller sees 1 observation
    and decides nothing."""
    got, want, built = _elastic_parity(tmp_path, monkeypatch, capsys, step_budget=18)
    assert got["decisions"] == want["decisions"] == []
    assert built == [(0, 40), (10, 18)]


# ----------------------------------------------------------------- train_100m
@pytest.mark.parametrize("scale", [0.25, 1.0])
def test_config_100m_is_the_reference_s(scale):
    got, want = train_100m.config_100m(scale), REF_100M.config_100m(scale)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()


def test_train_100m_matches_the_example_s_swap(tmp_path):
    """The reference builds a smoke stablelm-1.6b trainer and swaps the
    custom config in; the port builds on it (``TrainerOptions(cfg=)``)."""
    from repro.data.pipeline import SyntheticTokens as RefTokens
    from repro.models.model import LM as RefLM
    from repro.models.runtime import Runtime as RefRuntime

    steps, seq, batch = 4, 64, 4
    cfg = _f32(REF_100M.config_100m(0.25))
    ref = ref_train.Trainer(ref_train.TrainerOptions(
        arch=ARCH, smoke=True, steps=steps, seq_len=seq, global_batch=batch,
        ckpt_dir=str(tmp_path / "ref"), ckpt_every=50, log_every=20))
    ref.cfg = cfg
    ref.lm = RefLM(cfg, RefRuntime(remat="none", block_q=64, block_k=64))
    ref.data = RefTokens(cfg.vocab_size, seq, batch, seed=0)
    ref._build_state()
    ref._step_fn = ref._make_step()
    port = train_100m.build_trainer(_f32(train_100m.config_100m(0.25)), steps, seq, batch,
                                    str(tmp_path / "port"), "cpu")
    assert port.rt.remat == "none" and (port.rt.block_q, port.rt.block_k) == (64, 64)
    assert (port.opts.ckpt_every, port.opts.log_every, port.opts.seed) == (50, 20, 0)
    port.set_state(*_state_of(ref))
    ref.run()
    port.run()
    assert port.step == ref.step == steps
    _close([x for _, x in port.history], [x for _, x in ref.history])
    assert [t["step"] for t in port.ckpt.timings] == [t["step"] for t in ref.ckpt.timings]


# ---------------------------------------------------------------- autotune_lm
def _fixed_curves():
    rng = np.random.RandomState(0)
    i = np.arange(1, 31, dtype=np.float64)
    curves = {m: np.minimum.accumulate(3.0 + 2.5 * np.exp(-i * m ** 0.5 / 12.0)
                                       + 0.02 * rng.rand(30)) for m in (1, 2, 4)}
    return curves, {1: 0.031, 2: 0.034, 4: 0.041}


def test_autotune_cli_plans_as_the_reference_s_models(capsys):
    """``python -m repro_torch.autotune_lm --steps 8 --device cpu`` prints
    the example's lines; then ``examples/autotune_lm.py:46-67`` on the
    curves and step times it measured, fixed from there on."""
    got = autotune_lm.main(["--steps", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training tiny LM at data-parallel degrees [1, 2, 4]" in out
    assert "g(i,m) R^2 = " in out and "gradient bytes a sync: 4.8e+08" in out
    assert f"planner picks m={got['decision'].m} " in out
    curves, compute_s = got["curves"], got["compute_s"]
    assert sorted(curves) == [1, 2, 4] and all(len(c) == 8 for c in curves.values())
    ms, grad_bytes = [1, 2, 4], 4.0 * 120e6

    floor = min(c.min() for c in curves.values()) - 0.05
    data = RefData.from_curves(curves, floor)
    conv = RefConvergence().fit(data)
    comm = RefCommModel()
    times = [compute_s[m] + comm.iteration_comm(m, grad_bytes) for m in ms]
    sysm = RefErnest().fit(np.asarray(ms, float), np.full(len(ms), 1.0), np.asarray(times))
    target = float(np.median([c[-1] for c in curves.values()])) + 0.1
    planner = RefPlanner({"adamw-dp": RefCombined(sysm, conv, 1.0, 5_000)})
    d = planner.fastest_to_epsilon(target - floor, m_grid=[1, 2, 4, 8])
    assert d
    assert got["decision"].m == d.m
    assert got["active"] == sorted(conv.active_features())
    assert got["target"] == target and got["floor"] == floor
    assert abs(got["r2"] - conv.r2(data)) <= 1e-9 * abs(conv.r2(data))
    assert abs(got["decision"].predicted_time - d.predicted_time) <= 1e-9 * d.predicted_time
    assert got["predicted_s"].keys() == {m for _, m in d.table}
    assert 8 in got["iters"] and got["f_s"][8] > 0


class _NeverConverges:
    """A fitted g(i, m) whose gap never falls."""
    p_star = 0.0

    def fit(self, data):
        return self

    def predict(self, i, m):
        return np.full(len(i), np.inf)


def test_plan_raises_where_no_m_reaches_the_target(monkeypatch):
    """No fallback to a default m: the planner's NoFeasiblePlan raises."""
    curves, compute_s = _fixed_curves()
    monkeypatch.setattr(autotune_lm, "ConvergenceModel", _NeverConverges)
    with pytest.raises(RuntimeError, match="unexpectedly infeasible"):
        autotune_lm.plan(curves, compute_s, [1, 2, 4], 4.0 * 120e6)


def test_loss_curve_matches_the_example_s():
    """The example's ``loss_curve`` (seed 1, seq 64, global batch 2 m) at
    m = 1 and 2, 4 steps, the port from its drawn state."""
    for m in (1, 2):
        want = REF_AUTOTUNE.loss_curve(m, steps=4)
        params, _, opt_state = _DRAWN[(_f32(ref_smoke_config(ARCH)), 1)]
        state = (tree_from_numpy(params, "cpu"), tree_from_numpy(opt_state, "cpu"))
        got, _ = autotune_lm.loss_curve(m, 4, cfg=_f32(get_smoke_config(ARCH)), device="cpu",
                                        state=state)
        _close(list(got), list(want))


# ----------------------------------------------------------------------- CLIs
def test_clis_print_the_example_s_lines(capsys):
    trainer = train_100m.main(["--steps", "3", "--seq-len", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "model: lm-100m-s0.25: " in out and "trained 3 steps: loss " in out
    assert trainer.step == 3 and trainer.cfg.name == "lm-100m-s0.25"

    result = elastic_train.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("done at step 120, final loss ")
    assert out.splitlines()[-1].endswith("resize decisions: 0")
    assert result["failures"] == [17] and np.isfinite(result["final_loss"])

