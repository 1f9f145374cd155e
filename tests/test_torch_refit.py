"""Port parity: the streaming refits (``repro_torch.telemetry.refit``, a copy
of ``repro.telemetry.refit``) fed the same observations as the reference's
raise the same events and leave the same coefficients.

The module is numpy arithmetic on the host, copied unchanged, and the models
it refits are the port's copies of the reference's (Ernest's NNLS, the
capacity planner): so the events and coefficients are held bit for bit.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses

import numpy as np
import pytest

from repro.core.ernest import ErnestModel as RefErnest
from repro.fleet.workloads import AnalyticConvergence
from repro.serve.planner import CapacityPlanner as RefPlanner
from repro.telemetry import refit as ref_refit
from repro_torch.core.ernest import ErnestModel
from repro_torch.serve.planner import CapacityPlanner
from repro_torch.telemetry import refit


def _dicts(events):
    return [e.to_dict() for e in events]


def _feed(pair, stream):
    """Both wrappers observe each item of ``stream``; returns their events."""
    out = ([], [])
    for args in stream:
        for wrapper, events in zip(pair, out):
            events += wrapper.observe(*args)
    return tuple(_dicts(e) for e in out)


def test_drift_detector_matches_reference():
    rng = np.random.default_rng(0)
    cfg = dict(window=8, threshold=0.2, min_points=4, cooldown=10)
    ours = refit.DriftDetector("m", refit.DriftConfig(**cfg))
    theirs = ref_refit.DriftDetector("m", ref_refit.DriftConfig(**cfg))
    fired = 0
    for step in range(120):
        actual = (1.0 if step < 40 else 3.0) + 0.05 * rng.standard_normal()
        a, b = ours.observe(step, 1.0, actual), theirs.observe(step, 1.0, actual)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.to_dict() == b.to_dict()
            fired += 1
        assert ours.residual() == theirs.residual()
    assert fired >= 2


@pytest.mark.parametrize("refit_every", [0, 5])
def test_streaming_ernest_matches_reference(refit_every):
    def true_time(m, size, scale):
        return scale * (1.0 + 8.0 * size / m + 0.05 * np.log2(m))

    ms = np.array([1, 2, 4, 8, 1, 2, 4, 8], dtype=float)
    sizes = np.full_like(ms, 4.0)
    models = (ErnestModel().fit(ms, sizes, true_time(ms, sizes, 1.0)),
              RefErnest().fit(ms, sizes, true_time(ms, sizes, 1.0)))
    np.testing.assert_array_equal(models[0].theta, models[1].theta)
    cfg = dict(window=8, threshold=0.15, min_points=4, cooldown=4)
    pair = (refit.StreamingErnest(models[0], refit.DriftConfig(**cfg), window=16,
                                  refit_every=refit_every),
            ref_refit.StreamingErnest(models[1], ref_refit.DriftConfig(**cfg), window=16,
                                      refit_every=refit_every))
    stream = [(step, m, 4.0, true_time(m, 4.0, 1.0 if step < 16 else 2.0))
              for step, m in enumerate([1, 2, 4, 8] * 12)]
    ours, theirs = _feed(pair, stream)
    assert ours == theirs
    assert {e["kind"] for e in ours} >= {"refit"}
    np.testing.assert_array_equal(models[0].theta, models[1].theta)


def test_streaming_cost_matches_reference():
    cfg = dict(window=6, threshold=0.3, min_points=3, cooldown=5)
    pair = (refit.StreamingCost("restore", 1800.0, refit.DriftConfig(**cfg), window=8),
            ref_refit.StreamingCost("restore", 1800.0, ref_refit.DriftConfig(**cfg), window=8))
    stream = [(step, 40.0 + step % 3) for step in range(20)]
    ours, theirs = _feed(pair, stream)
    assert ours == theirs
    assert {e["kind"] for e in ours} == {"ckpt_cost", "drift", "refit"}
    assert pair[0].learned == pair[1].learned and pair[0].estimate_s == pair[1].estimate_s


def test_streaming_capacity_matches_reference():
    planners = (CapacityPlanner(), RefPlanner())
    for p in planners:
        for b in (1, 2, 4, 8):
            p.observe(b, 0.010 + 0.002 * b)
        p.fit()
    np.testing.assert_array_equal(planners[0].step_model.theta, planners[1].step_model.theta)
    cfg = dict(window=8, threshold=0.2, min_points=4, cooldown=6)
    pair = (refit.StreamingCapacity(planners[0], refit.DriftConfig(**cfg)),
            ref_refit.StreamingCapacity(planners[1], ref_refit.DriftConfig(**cfg)))
    stream = [(step, b, (0.010 + 0.002 * b) * (1.0 if step < 12 else 1.8))
              for step, b in enumerate([1, 2, 4, 8] * 8)]
    ours, theirs = _feed(pair, stream)
    assert ours == theirs
    assert {e["kind"] for e in ours} == {"drift", "refit"}
    np.testing.assert_array_equal(planners[0].step_model.theta, planners[1].step_model.theta)


def test_streaming_convergence_matches_reference():
    """Both wrap the same duck-typed analytic g(i, m) (the reference's
    fleet model; the module only reads its fields and ``predict``)."""
    model = AnalyticConvergence(p_star=0.1, gap0=1.0, rate=0.05, alpha=0.35)
    cfg = dict(window=8, threshold=0.2, min_points=4, cooldown=6)
    pair = (refit.StreamingConvergence(model, refit.DriftConfig(**cfg)),
            ref_refit.StreamingConvergence(model, ref_refit.DriftConfig(**cfg)))
    # the run converges twice as slowly as the model says
    slow = dataclasses.replace(model, rate=0.025)
    stream = [(step, float(step), 4, float(slow.predict(step, 4)[0])) for step in range(40)]
    ours, theirs = _feed(pair, stream)
    assert ours == theirs
    assert "refit" in {e["kind"] for e in ours}
    assert pair[0].model == pair[1].model != model


def test_telemetry_exports_the_refits():
    import repro.telemetry as ref_telemetry
    import repro_torch.telemetry as telemetry

    names = ("DriftConfig", "DriftDetector", "StreamingCapacity", "StreamingConvergence",
             "StreamingCost", "StreamingErnest")
    for name in names:
        assert name in telemetry.__all__ and name in ref_telemetry.__all__
        assert getattr(telemetry, name) is getattr(refit, name)
