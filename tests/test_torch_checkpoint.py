"""Checkpoints that cross between the packages, and the port's trainer
restored from one.

The port's ``CheckpointManager`` writes format 2 in the reference's tree
layout; the reference's manager restores it, and the port's restores the
reference's, bit for bit (float32 master parameters, AdamW's state, int32
counts, and a bf16 leaf stored as its uint16 bits), for the dense, the
Mamba, the MoE and the MLA + MoE trees (the smoke stablelm, falcon-mamba,
deepseek-moe and deepseek-v2, whose dense first layers sit in
``head_layers``), jamba's hybrid period (8 layers, its leaves stacked per
position) and a frontend arch's (musicgen's ``frontend_proj``), through the
port's LM.  A port ``Trainer``
restored from a step continues with the same losses and parameters as one
that never stopped, bit for bit on the CPU (the same operations on the same
values); ``run()`` survives a simulated failure the same way.  A torn
shard raises ``CorruptCheckpoint`` or, with fallback, restores the previous
complete step; a format-1 step reads.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import dataclasses
import io
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.model import LM as RefLM
from repro.training import optimizers as ref_opt
from repro_torch.checkpoint import CheckpointManager, CorruptCheckpoint
from repro_torch.configs import get_smoke_config
from repro_torch.convert import load_tree_into_lm, tree_from_lm, tree_from_numpy, tree_to_numpy
from repro_torch.launch.train import Trainer, TrainerOptions
from repro_torch.models.model import LM
from repro_torch.runtime.failures import FailureInjector
from repro_torch.training import optimizers as port_opt
from repro_torch.training.tree import tree_leaves


# the smoke configs at 2 layers: attention and SwiGLU; Mamba; a dense head
# layer (``head_layers``) and a MoE layer with a shared expert; the same
# with MLA attention; musicgen's frontend projection; and jamba at its
# period of 8 (Mamba and attention mixers, dense and MoE FFNs)
ARCHS = ["stablelm-1.6b", "falcon-mamba-7b", "deepseek-moe-16b", "deepseek-v2-236b",
         "musicgen-medium", "jamba-1.5-large-398b"]


def _layers(arch):
    return max(2, len(get_smoke_config(arch).period))


def _ref_state(arch="stablelm-1.6b"):
    cfg = dataclasses.replace(ref_smoke_config(arch), n_layers=_layers(arch), dtype="float32")
    params, _ = RefLM(cfg).init(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    opt = ref_opt.adamw()
    _, state = opt.update(params, opt.init(params), params, np.float32(1e-3))
    return params, jax.tree.map(np.asarray, state)


def _port_lm(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=_layers(arch), dtype="float32")
    return LM(cfg, device="cpu")


def _same_bits(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g.reshape(-1).view(np.uint8), w.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_reference(tmp_path, arch):
    """The port's LM's tree (``tree_from_lm``, the reference's layout: for
    Mamba ``in_proj``, ``conv_w/b``, ``x_proj``, ``dt_w/b``, ``A_log``, ``D``,
    ``out_proj``; for MoE ``router``, ``w_gate/up/down``, ``sh_*``; the dense
    head in ``head_layers``) saved by the port restores in the reference."""
    params, state = _ref_state(arch)
    lm = load_tree_into_lm(_port_lm(arch), params)
    tree = {"params": tree_from_lm(lm), "opt_state": tree_from_numpy(state, "cpu"),
            "extra": {"half": torch.randn(3, 5).to(torch.bfloat16)}}
    CheckpointManager(tmp_path).save_async(7, tree, metadata={"arch": "x"}).wait()
    got, meta = RefManager(tmp_path).restore()
    assert meta["step"] == 7 and meta["arch"] == "x"
    assert got["extra"]["half"].dtype == ml_dtypes.bfloat16
    want_half = tree["extra"]["half"].float().numpy().astype(ml_dtypes.bfloat16)
    _same_bits(got["extra"]["half"], want_half)
    _same_bits({"params": got["params"], "opt_state": got["opt_state"]},
               {"params": params, "opt_state": state})


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_restores_in_port(tmp_path, arch):
    """The reverse: the reference's checkpoint restores in the port and
    loads into its LM, whose tree gives the same bits back."""
    params, state = _ref_state(arch)
    half = np.arange(12, dtype=np.float32).reshape(3, 4).astype(ml_dtypes.bfloat16)
    RefManager(tmp_path).save_async(3, {"params": params, "opt_state": state,
                                        "extra": {"half": half}},
                                    metadata={"data_state": {"seed": 0, "step": 3}}).wait()
    got, meta = CheckpointManager(tmp_path).restore()
    assert meta["data_state"] == {"seed": 0, "step": 3}
    assert got["extra"]["half"].dtype == torch.bfloat16
    assert torch.equal(got["extra"]["half"], torch.arange(12.0).reshape(3, 4).to(torch.bfloat16))
    _same_bits(tree_to_numpy({"params": got["params"], "opt_state": got["opt_state"]}),
               {"params": params, "opt_state": state})
    assert isinstance(got["opt_state"]["count"], torch.Tensor)
    assert got["opt_state"]["count"].dtype == torch.int32
    lm = load_tree_into_lm(_port_lm(arch), got["params"])
    _same_bits(tree_to_numpy(tree_from_lm(lm)), params)


def _opts(tmp_path, **kw):
    base = dict(arch="stablelm-1.6b", smoke=True, steps=4, seq_len=16, global_batch=2,
                ckpt_dir=str(tmp_path), ckpt_every=2, log_every=0, device="cpu",
                cfg=dataclasses.replace(get_smoke_config("stablelm-1.6b"), n_layers=2))
    base.update(kw)
    return TrainerOptions(**base)


def test_restored_trainer_continues_like_one_that_never_stopped(tmp_path):
    a = Trainer(_opts(tmp_path / "a"))
    a.train_some(4)
    a.ckpt.wait()
    b = Trainer(_opts(tmp_path / "b"))
    b.train_some(1)  # b's state moves away; the restore replaces all of it
    b.ckpt = a.ckpt
    assert b.restore(2) and b.step == 2
    b.train_some(2)
    assert b.history[1:] == a.history[2:]  # (step, loss) pairs, the losses bit for bit
    _same_bits(tree_to_numpy(b.params), tree_to_numpy(a.params))
    _same_bits(tree_to_numpy(b.opt_state), tree_to_numpy(a.opt_state))


def test_run_survives_a_failure_by_restoring(tmp_path):
    clean = Trainer(_opts(tmp_path / "clean", steps=5))
    clean.run()
    failing = Trainer(_opts(tmp_path / "fail", steps=5, failure_injector=FailureInjector.at(3)))
    failing.run()
    assert failing.step == 5
    assert [s for s, _ in failing.history] == [0, 1, 2, 2, 3, 4]  # step 2 again after restore
    _same_bits(tree_to_numpy(failing.params), tree_to_numpy(clean.params))
    assert failing.ckpt.last_timing("restore")["wall_s"] >= 0


def test_torn_shard_raises_or_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    for step in (1, 2):
        mgr.save_async(step, {"w": torch.full((4,), float(step))})
    shard = tmp_path / "step_00000002" / "shard_0000.npz"
    shard.write_bytes(shard.read_bytes()[:20])
    with pytest.raises(CorruptCheckpoint):
        mgr.restore(2, fallback=False)
    with pytest.warns(RuntimeWarning, match="fell back to step 1"):
        tree, meta = mgr.restore(2)
    assert meta["step"] == 1 and torch.equal(tree["w"], torch.ones(4))


def test_keep_and_format_1(tmp_path):
    mgr = CheckpointManager(tmp_path / "k", keep=2, async_write=False)
    for step in range(4):
        mgr.save_async(step, {"w": torch.zeros(2)})
    assert mgr.all_steps() == [2, 3] and mgr.last_timing("save")["step"] == 3
    legacy = tmp_path / "f1" / "step_00000005"
    legacy.mkdir(parents=True)
    buf = io.BytesIO()
    np.savez(buf, **{"params/w": np.arange(3, dtype=np.float32), "count": np.int32(4)})
    (legacy / "arrays.npz").write_bytes(buf.getvalue())
    (legacy / "manifest.json").write_text(json.dumps({
        "step": 5, "metadata": {"step": 5},
        "arrays": {"params/w": {"shape": [3], "dtype": "float32"},
                   "count": {"shape": [], "dtype": "int32"}}}))
    (legacy / "COMMITTED").write_text("ok")
    tree, meta = CheckpointManager(tmp_path / "f1").restore()
    assert meta["step"] == 5 and int(tree["count"]) == 4
    assert torch.equal(tree["params"]["w"], torch.arange(3.0))


def test_adafactor_state_round_trips(tmp_path):
    params, _ = _ref_state()
    opt = port_opt.adafactor()
    tp = tree_from_numpy(params, "cpu")
    _, state = opt.update(tp, opt.init(tp), tp, torch.tensor(1e-3))
    CheckpointManager(tmp_path).save_async(1, {"opt_state": state}).wait()
    got, _ = RefManager(tmp_path).restore()
    _same_bits(got["opt_state"], tree_to_numpy(state))
