"""The MoE FFN's expert-parallel and 2-D paths (``repro_torch.models.moe``)
against the reference's ``shard_map`` paths (``repro/models/moe.py:212-303``)
and against the port's local path, on the CPU, float32, at the smoke
deepseek-moe-16b's and jamba's widths (d_model 64, 8 experts of d_ff 64,
top-2; deepseek-moe with one shared expert), at a capacity factor of 0.5.

* The expert-parallel path on two gloo ranks, a (1, 2) mesh (4 experts a
  rank, ``Rules.default``: the tokens over "data"), and the 2-D path on four,
  a (2, 2) mesh whose rules leave the tokens replicated (the experts' d_model
  in two blocks over "data", the gate and up partials summed there, the
  output gathered there).
* The reference's paths run in a subprocess on eight forced host devices,
  as ``tests/test_moe_2d.py`` runs them, with ``jax.value_and_grad`` of
  sum(y ct) + aux.
* In eval (dropless) and in training (the Switch/GShard capacity, which
  drops assignments here): y within 1e-5 of its largest magnitude and aux
  within 1e-6 relative of the reference's shard_map and of the port's
  local path; every expert, shared and router leaf's gradient, the ranks'
  slices put together, and x's, within 1e-4 of each leaf's largest of the
  reference's ``shard_map`` gradient and of the port's local path's (the
  products and sums in another order; ``tests/test_torch_moe_train.py``'s
  bounds).
* The ranks' outputs are the same bits, and, in eval, a token's output does
  not depend on the other tokens (the rows after ``KEEP`` changed).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_tp_ranks import Spawned
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import moe as ref_moe
from repro.models.param import split_tree
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ["deepseek-moe-16b", "jamba-1.5-large-398b"]
PATHS = {"ep": (2, 1), "2d": (4, 2)}  # path: (ranks, data)
B, S, KEEP = 4, 8, 5
RTOL, AUX_RTOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4
CAPACITY_FACTOR = 0.5  # the training capacity drops assignments on these inputs
SPAWN_TIMEOUT_S = 240

REF_SCRIPT = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.dist.partitioning import Rules
from repro.launch.mesh import make_debug_mesh
from repro.models import moe as moe_mod

inp = np.load(sys.argv[1])
CF = float(inp["capacity_factor"])
out = {}
for arch in sys.argv[3:]:
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=CF))
    params = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith(arch + "/p/")}
    params = {k[2:]: v for k, v in params.items()}
    x, ct = jnp.asarray(inp[arch + "/x"]), jnp.asarray(inp[arch + "/ct"])
    for path, (data, model) in {"ep": (1, 2), "2d": (2, 2)}.items():
        mesh = make_debug_mesh(data, model)
        rules = Rules.default(mesh)
        if path == "2d":
            rules = rules.override(acts={"batch": None})
        for train in (False, True):
            def f(p, xx):
                y, aux = moe_mod.apply_moe(p, xx, cfg, train=train, mesh=mesh, rules=rules)
                return jnp.sum(y * ct) + aux, (y, aux)
            with mesh:
                (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True))(params, x)
            key = f"{arch}/{path}/{'train' if train else 'eval'}"
            out[key + "/y"] = np.asarray(y)
            out[key + "/aux"] = np.asarray(aux)
            if train:
                out[key + "/x_grad"] = np.asarray(gx)
                for k, v in gp.items():
                    out[key + "/g/" + k] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("REF_OK")
"""


def _cfgs(arch):
    return tuple(dataclasses.replace(c, dtype="float32", moe=dataclasses.replace(
        c.moe, capacity_factor=CAPACITY_FACTOR))
        for c in (ref_smoke_config(arch), get_smoke_config(arch)))


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()) + 1e-12, (what, err, np.abs(want).max())


def _inputs():
    out = {}
    for n, arch in enumerate(ARCHS):
        ref_cfg, _ = _cfgs(arch)
        params, _ = split_tree(ref_moe.init_moe(jax.random.PRNGKey(n), ref_cfg))
        rng = np.random.RandomState(10 + n)
        out[arch] = {"params": {k: np.asarray(v, np.float32) for k, v in params.items()},
                     "x": (rng.randn(B, S, ref_cfg.d_model) * 0.5).astype(np.float32),
                     "ct": rng.randn(B, S, ref_cfg.d_model).astype(np.float32),
                     "other": (rng.randn(B, S, ref_cfg.d_model) * 0.5).astype(np.float32)}
    return out


def _local_path(arch, inputs):
    """The port's local path (no mesh) in eval and training, with grads."""
    _, cfg = _cfgs(arch)
    out = {}
    p = {k: torch.from_numpy(v.copy()) for k, v in inputs["params"].items()}
    x = torch.from_numpy(inputs["x"].copy())
    with torch.no_grad():
        out["eval"] = {"y": moe.apply_moe(p, x, cfg).numpy()}
    for t in p.values():
        t.requires_grad_(True)
    x.requires_grad_(True)
    y, aux = moe.apply_moe(p, x, cfg, train=True)
    ((y * torch.from_numpy(inputs["ct"])).sum() + aux).backward()
    out["train"] = {"y": y.detach().numpy(), "aux": float(aux.detach()),
                    "x_grad": x.grad.numpy(),
                    "grads": {k: t.grad.numpy() for k, t in p.items()}}
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks of both paths (started first), the reference's shard_map
    paths in a subprocess, and the port's local path, computed meanwhile."""
    inputs = _inputs()
    groups = {}
    for path, (world, data) in PATHS.items():
        jobs = {arch: {"kind": "moe", "path": path, "cfg": _cfgs(arch)[1], "keep": KEEP,
                       **inputs[arch]} for arch in ARCHS}
        groups[path] = Spawned(world, jobs, str(tmp_path_factory.mktemp(f"moe_{path}")),
                               SPAWN_TIMEOUT_S, data=data)
    work = tmp_path_factory.mktemp("moe_ref")
    flat = {f"{arch}/p/{k}": v for arch in ARCHS for k, v in inputs[arch]["params"].items()}
    flat.update({f"{arch}/{k}": inputs[arch][k] for arch in ARCHS for k in ("x", "ct")})
    flat["capacity_factor"] = np.float64(CAPACITY_FACTOR)
    np.savez(work / "in.npz", **flat)
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(work / "in.npz"), str(work / "out.npz"), *ARCHS],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    local = {arch: _local_path(arch, inputs[arch]) for arch in ARCHS}
    stdout, stderr = ref.communicate(timeout=420)
    assert "REF_OK" in stdout, stderr[-3000:]
    reference = dict(np.load(work / "out.npz"))
    return inputs, local, reference, {path: g.results() for path, g in groups.items()}


def _whole_grads(ranks, arch, path):
    """The ranks' gradient slices put together: experts over "model", their
    d_model blocks over "data" (2-D), the router's and shared columns and
    ``sh_down``'s rows over "model"; replicated ranks must agree."""
    world, data = PATHS[path]
    model = world // data
    grid = [[ranks[i * model + r][arch]["train"]["grads"] for r in range(model)]
            for i in range(data)]
    out = {}
    for k in grid[0][0]:
        if k in ("w_gate", "w_up", "w_down"):
            dim = 1 if k != "w_down" else 2
            rows = [np.concatenate([grid[i][r][k] for i in range(data)], axis=dim)
                    if path == "2d" else grid[0][r][k] for r in range(model)]
            out[k] = np.concatenate(rows, axis=0)
        else:
            axis = 0 if k == "sh_down" else 1
            out[k] = np.concatenate([grid[0][r][k] for r in range(model)], axis=axis)
            for i in range(1, data):  # the spare axes hold the same columns
                np.testing.assert_array_equal(
                    np.concatenate([grid[i][r][k] for r in range(model)], axis=axis), out[k])
    return out


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_eval_matches_the_shard_map_path_and_the_local_path(arch, path, run):
    inputs, local, reference, results = run
    ranks = results[path]
    want = reference[f"{arch}/{path}/eval/y"]
    for res in ranks:
        got = res[arch]["eval"]
        y = got["y"]  # every rank's is the whole batch's (data 1, or replicated tokens)
        _close(y, want, RTOL, "y vs the reference's shard_map")
        _close(y, local[arch]["eval"]["y"], RTOL, "y vs the local path")
        assert got["kept_alone"]
    for res in ranks[1:]:  # the ranks in step
        np.testing.assert_array_equal(res[arch]["eval"]["y"], ranks[0][arch]["eval"]["y"])


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_training_matches_the_shard_map_path_and_the_local_path(arch, path, run):
    inputs, local, reference, results = run
    ranks = results[path]
    key = f"{arch}/{path}/train"
    want_local = local[arch]["train"]
    for res in ranks:
        got = res[arch]["train"]
        _close(got["y"], reference[key + "/y"], RTOL, "y vs the reference's shard_map")
        _close(got["y"], want_local["y"], RTOL, "y vs the local path")
        assert abs(got["aux"] - float(reference[key + "/aux"])) <= AUX_RTOL * got["aux"]
        assert abs(got["aux"] - want_local["aux"]) <= AUX_RTOL * got["aux"]
        _close(got["x_grad"], want_local["x_grad"], GRAD_RTOL, "x's gradient")
    for res in ranks[1:]:
        np.testing.assert_array_equal(res[arch]["train"]["y"], ranks[0][arch]["train"]["y"])
        np.testing.assert_array_equal(res[arch]["train"]["x_grad"],
                                      ranks[0][arch]["train"]["x_grad"])
    grads = _whole_grads(ranks, arch, path)
    assert set(grads) == set(inputs[arch]["params"])
    for k, g in grads.items():
        _close(g, want_local["grads"][k], GRAD_RTOL, f"{k}'s gradient vs the local path")
        _close(g, reference[key + "/g/" + k], GRAD_RTOL, f"{k}'s gradient vs shard_map")
    _close(ranks[0][arch]["train"]["x_grad"], reference[key + "/x_grad"], GRAD_RTOL,
           "x's gradient vs shard_map")


def test_training_drops_assignments_here(run):
    """The training capacity drops assignments on these inputs, so the
    drop bucket and the capacity's rank order are exercised."""
    inputs, _, _, _ = run
    for arch in ARCHS:
        _, cfg = _cfgs(arch)
        xt = torch.from_numpy(inputs[arch]["x"]).reshape(B * S, -1)
        p = {k: torch.from_numpy(v.copy()) for k, v in inputs[arch]["params"].items()}
        ids, _ = moe.route(p, xt, cfg)
        counts = torch.bincount(ids.reshape(-1), minlength=cfg.moe.n_routed_experts)
        assert int(counts.max()) > moe.capacity(B * S, cfg.moe, train=True), arch
