"""The dry-run (``repro_torch.launch.dryrun``) against the reference's
``repro/launch/dryrun.py``, on the CPU and the "meta" device.

* ``attach_tuned_kernels`` on one tuner cache (the same entries written
  through each package's ``ConfigCache``): the reference's
  ``tuned_kernel_rows`` (names, microseconds, derived fields; the
  ``x_lightspeed`` column is each package's own roofline's, the H100's and
  the TPU's) and its ``t_kernel_measured_s`` (layers x the matching batch's
  paged-decode time), entries at other batches ignored;
* ``fm_sweep --smoke`` over falcon-mamba-7b's smoke config at 1, 2, 4 and
  8 cards fits the same Ernest coefficients as the reference's
  ``ErnestModel`` on the same samples;
* a MoE cell at a "model" axis of 8 is ``ok`` on both production meshes
  (the expert-parallel path's collectives over "model" recorded);
* stablelm-1.6b at full config on the production mesh (32, 8): a train, a
  prefill and a decode cell are ``ok``, with the reference's fields, finite
  positive times, the train cell's optimizer, and a ``useful_flops_ratio``
  in (0.3, 1.2] (full remat recomputes each layer's forward).

The reference's own cells do not run here (its sharded programs fail on
this host's JAX, ROADMAP.md queue 3), so the port's cells are held against
the reference's shape-only functions, hand counts and its recorded sweep's
``n_params`` (``tests/test_torch_dryrun_inputs.py``).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import math
import os

import jax
import pytest

from repro.core.ernest import ErnestModel as RefErnest
from repro.kernels.tune.cache import ConfigCache as RefConfigCache
from repro.kernels.tune.cache import cache_key as ref_cache_key
from repro_torch.configs import get_config
from repro_torch.kernels.tune.cache import ConfigCache, cache_key
from repro_torch.launch import dryrun

ENTRIES = [("flash_decode_paged", {"b": 128, "hk": 8, "g": 5, "d": 128, "page": 16,
                                   "npp": 2048}, {"pages_per_program": 4}, 812.5),
           ("flash_decode_paged", {"b": 128, "hk": 8, "g": 5, "d": 128, "page": 16,
                                   "npp": 1024}, {"pages_per_program": 8}, 431.25),
           ("flash_decode_paged", {"b": 8, "hk": 8, "g": 5, "d": 128, "page": 16,
                                   "npp": 2048}, {"pages_per_program": 2}, 77.0),
           ("flash_attention", {"b": 1, "h": 8, "s": 1024, "d": 64},
            {"block_q": 16, "block_k": 64}, 51.5)]


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module, imported after this process's JAX
    backend is up, with the device-count flag it sets at import taken back
    (so that nothing started later sees it)."""
    saved = os.environ.get("XLA_FLAGS")
    jax.devices()
    try:
        import repro.launch.dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


def _write(cache, key_fn, path):
    for family, shape, config, us in ENTRIES:
        cache.put(key_fn(family, shape, "bfloat16", "cuda"), family=family, shape=shape,
                  dtype="bfloat16", config=config, us_per_call=us, swept=3, pruned=2,
                  backend="cuda")
    cache.save()
    return str(path)


def test_attach_tuned_kernels_is_the_reference_s(ref_dryrun, tmp_path):
    port = _write(ConfigCache(str(tmp_path / "port.json")), cache_key, tmp_path / "port.json")
    ref = _write(RefConfigCache(str(tmp_path / "ref.json")), ref_cache_key,
                 tmp_path / "ref.json")
    for shape in ("decode_32k", "train_4k", "long_500k"):
        got = dryrun.attach_tuned_kernels({"arch": "qwen3-14b", "shape": shape,
                                           "kind": "train" if shape == "train_4k"
                                           else "decode"}, port)
        want = ref_dryrun.attach_tuned_kernels({"arch": "qwen3-14b", "shape": shape,
                                                "kind": "train" if shape == "train_4k"
                                                else "decode"}, ref)
        assert len(got["tuned_kernel_rows"]) == len(want["tuned_kernel_rows"]) == len(ENTRIES)
        for g, w in zip(got["tuned_kernel_rows"], want["tuned_kernel_rows"]):
            assert (g["name"], g["us_per_call"]) == (w["name"], w["us_per_call"])
            strip = (lambda d: d.rsplit(";x_lightspeed=", 1)[0])
            assert strip(g["derived"]) == strip(w["derived"])
        assert got.get("t_kernel_measured_s") == want.get("t_kernel_measured_s")
    decode = dryrun.attach_tuned_kernels({"arch": "qwen3-14b", "shape": "decode_32k",
                                          "kind": "decode"}, port)
    assert decode["t_kernel_measured_s"] == 40 * 431.25e-6  # b 128's fastest, 40 layers
    long = dryrun.attach_tuned_kernels({"arch": "qwen3-14b", "shape": "long_500k",
                                        "kind": "decode"}, port)
    assert "t_kernel_measured_s" not in long  # b 1: no entry at that batch


def test_fm_sweep_fits_the_reference_s_ernest_coefficients(tmp_path):
    result = dryrun.fm_sweep("falcon-mamba-7b", "decode_32k", [1, 2, 4, 8], tmp_path,
                             smoke=True)
    samples = result["samples"]
    assert [s["m"] for s in samples] == [1, 2, 4, 8]
    assert all(s["t_step_s"] > 0 and math.isfinite(s["t_step_s"]) for s in samples)
    ref = RefErnest().fit([s["m"] for s in samples], [s["size"] for s in samples],
                          [s["t_step_s"] for s in samples])
    assert result["ernest_terms"] == list(ref.term_names)
    assert result["ernest_theta"] == ref.coefficients()
    assert (tmp_path / "fm__falcon-mamba-7b__decode_32k__smoke.json").exists()


def test_a_moe_cell_at_model_8_is_ok_on_both_meshes(tmp_path):
    """deepseek-moe-16b's decode on the production meshes: 64 experts, 8 a
    rank on the expert-parallel path, the router's logits gathered over
    "model" and the rank's partials summed there; the FSDP weights
    gathered over the batch axes."""
    results = dryrun.main(["--arch", "deepseek-moe-16b", "--shape", "decode_32k",
                           "--mesh", "both", "--out", str(tmp_path)])
    assert [r["status"] for r in results] == ["ok", "ok"], [r.get("error") for r in results]
    for r in results:
        assert r["collective_wire_by_axis_per_device"]["model"] > 0
        assert set(r["collective_breakdown_per_device"]) == {"all-gather", "all-reduce"}
        assert r["n_params"] == get_config("deepseek-moe-16b").param_count()
    assert len(list(tmp_path.glob("deepseek-moe-16b__decode_32k__*.json"))) == 2


FIELDS = ("flops_per_device", "bytes_per_device", "xla_cost_analysis_flops",
          "xla_cost_analysis_bytes", "n_while_loops", "collective_bytes_per_device",
          "collective_wire_bytes_per_device", "collective_breakdown_per_device",
          "collective_wire_breakdown_per_device", "t_compute_s", "t_memory_s",
          "t_collective_s", "dominant", "model_flops", "useful_flops_ratio",
          "memory_analysis", "n_params", "n_params_active", "mesh", "mesh_axes", "chips")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_stablelm_full_config_cells_on_the_production_mesh(shape, tmp_path):
    r = dryrun.run_cell("stablelm-1.6b", shape, "single", tmp_path)
    assert r["status"] == "ok", r.get("error")
    assert set(FIELDS) <= set(r)
    assert r["mesh"] == [32, 8] and r["chips"] == 256 and r["n_while_loops"] == 0
    for key in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert math.isfinite(r[key]) and r[key] > 0, key
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["n_params"] == get_config("stablelm-1.6b").param_count()
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert mem["generated_code_size_in_bytes"] == -1
    assert r["collective_wire_by_axis_per_device"]["model"] > 0
    if shape == "train_4k":
        assert r["optimizer"] == "adamw"
        assert 0.3 < r["useful_flops_ratio"] <= 1.2
        # full remat: K3 twice a layer, each backward pass once (24 layers)
        assert r["kernels"]["flash_fwd"]["launches"] == 48
        assert r["kernels"]["flash_bwd_dq"]["launches"] == 24
        assert set(r["collective_breakdown_per_device"]) == {"all-gather", "all-reduce",
                                                             "reduce-scatter"}
    else:
        assert r["optimizer"] is None
