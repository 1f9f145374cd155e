"""The port's kernel autotuner (``repro_torch.kernels.tune``) on the CPU,
case for case with ``tests/test_tune.py``, and against the reference's
``repro.kernels.tune``: the same candidate spaces and FLOP counts, the same
cache keys and file format (a file written by either package loads in the
other), the capacity planner fitted from tune events to the reference's step
times, and the ``tuned`` hooks of the port's wrappers and serve CLI.

Every cache lives under ``tmp_path``; tests that touch the process-wide cache
point ``$REPRO_TORCH_TUNE_CACHE`` there and reset it afterwards.

Tolerances: float32 atol 1e-5 where kernels' outputs are compared with the
reference; a tuned call is held bit for bit against the same call with the
value named explicitly; the planners' step times to rel 1e-6 (two copies of
the same least-squares fit).
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.tune as ref_tune
from repro.kernels.tune.roofline import estimate as ref_estimate
from repro.serve import CapacityPlanner as RefPlanner
from repro_torch.kernels import tune
from repro_torch.kernels._build import MAX_SMEM_PER_BLOCK
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.tune import (
    FAMILIES,
    SWEEP_SHAPES,
    ConfigCache,
    bench_rows,
    cache_key,
    candidates_for,
    decode_step_rows,
    ensure,
    ragged_lengths,
    shape_sig,
    sweep,
    tune_events,
)
from repro_torch.kernels.tune import roofline as roofline_mod
from repro_torch.kernels.tune.roofline import estimate, light_speed_s, prune
from repro_torch.kernels.tune.sweep import sweep_dtype
from repro_torch.serve import CapacityPlanner

SHAPE = dict(SWEEP_SHAPES["smoke"]["flash_decode_paged"])
CPU = torch.device("cpu")


@pytest.fixture
def default_cache_at(tmp_path, monkeypatch):
    """The process-wide cache pointed at an empty file under tmp_path."""
    path = tmp_path / "default.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(path))
    tune.reset_default_cache()
    yield path
    tune.reset_default_cache()


def _put(cache, family, shape, config, dtype="float32", backend="cpu", us=10.0):
    cache.put(cache_key(family, shape, dtype, backend), family=family, shape=shape,
              dtype=dtype, config=config, us_per_call=us, swept=1, pruned=0, backend=backend)


# ------------------------------------------------------------------- cache
def test_config_cache_roundtrip(tmp_path):
    path = tmp_path / "tune.json"
    cache = ConfigCache(str(path))
    key = cache_key("flash_decode_paged", SHAPE, torch.float32, "cpu")
    assert "flash_decode_paged|" in key and "|float32|cpu" in key
    cache.put(key, family="flash_decode_paged", shape=SHAPE, dtype=torch.float32,
              config={"pages_per_program": 2}, us_per_call=123.4, swept=3, pruned=4,
              backend="cpu")
    cache.save()
    reloaded = ConfigCache(str(path))
    entry = reloaded.get(key)
    assert entry["config"] == {"pages_per_program": 2}
    assert entry["us_per_call"] == pytest.approx(123.4)
    assert entry["candidates_swept"] == 3 and entry["candidates_pruned"] == 4
    assert reloaded.config(key) == {"pages_per_program": 2}
    payload = json.loads(path.read_text())
    assert payload["version"] == 1 and key in payload["entries"]
    payload["version"] = 0  # a stale schema is discarded, not misread
    path.write_text(json.dumps(payload))
    assert ConfigCache(str(path)).entries == {}


def test_cache_key_dtype_and_backend_separation():
    k1 = cache_key("ssm_scan", {"s": 64}, torch.float32, "cpu")
    k2 = cache_key("ssm_scan", {"s": 64}, torch.bfloat16, "cpu")
    k3 = cache_key("ssm_scan", {"s": 64}, torch.float32, "cuda")
    assert len({k1, k2, k3}) == 3
    with pytest.raises(ValueError):
        cache_key("ssm_scan", {"s": 64}, "not_a_dtype", "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_key_and_shape_sig_match_reference(dtype):
    from repro.kernels.tune.cache import cache_key as ref_key
    from repro.kernels.tune.cache import shape_sig as ref_sig

    for preset in SWEEP_SHAPES:
        for family, shape in SWEEP_SHAPES[preset].items():
            assert shape_sig(shape) == ref_sig(shape)
            want = ref_key(family, shape, jnp.dtype(dtype), backend="cpu")
            assert cache_key(family, shape, getattr(torch, dtype), "cpu") == want
            assert cache_key(family, shape, dtype, "cpu") == want


def test_cache_files_load_across_packages(tmp_path):
    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    cache = ConfigCache(str(ours))
    _put(cache, "flash_decode_paged", SHAPE, {"pages_per_program": 2}, "bfloat16", "cuda")
    _put(cache, "ssm_scan", SWEEP_SHAPES["smoke"]["ssm_scan"], {"chunk": 32})
    cache.save()
    assert ref_tune.ConfigCache(str(ours)).entries == cache.entries
    ref = ref_tune.ConfigCache(str(theirs))
    shape = SWEEP_SHAPES["smoke"]["flash_decode"]
    ref.put(ref_tune.cache_key("flash_decode", shape, jnp.float32, backend="cpu"),
            family="flash_decode", shape=shape, dtype=jnp.float32, config={"block_k": 32},
            us_per_call=5.0, swept=2, pruned=1, backend="cpu")
    ref.save()
    loaded = ConfigCache(str(theirs))
    assert loaded.entries == ref.entries
    assert loaded.config(cache_key("flash_decode", shape, "float32", "cpu")) == {"block_k": 32}


def test_default_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/elsewhere/ref.json")
    assert ConfigCache.default_path() == "results/tune_cache_torch.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "/somewhere/t.json")
    assert ConfigCache.default_path() == "/somewhere/t.json"


# ------------------------------------------------------------------- sweep
def test_ensure_returns_cached_config_without_resweeping(tmp_path):
    cache = ConfigCache(str(tmp_path / "tune.json"))
    cfg1 = ensure("flash_decode_paged", SHAPE, torch.float32, device="cpu", cache=cache,
                  iters=1)
    assert cache.sweeps == 1
    cfg2 = ensure("flash_decode_paged", SHAPE, torch.float32, device="cpu", cache=cache,
                  iters=1)
    assert cfg2 == cfg1 and cache.sweeps == 1, "second ensure() must not re-sweep"
    fresh = ConfigCache(str(tmp_path / "tune.json"))
    assert ensure("flash_decode_paged", SHAPE, torch.float32, device="cpu", cache=fresh,
                  sweep_on_miss=False) == cfg1
    assert fresh.sweeps == 0
    assert ensure("flash_decode_paged", SHAPE, torch.bfloat16, device="cpu", cache=fresh,
                  sweep_on_miss=False) is None


@pytest.mark.parametrize("family", FAMILIES)
def test_smoke_sweep_every_family(family):
    """Each family sweeps at its smoke shape on the CPU (the plain
    versions), returns a candidate from its own space, and records pruning."""
    cache = ConfigCache(path=None)
    shape = SWEEP_SHAPES["smoke"][family]
    config, entry = sweep(family, shape, device="cpu", cache=cache, iters=1)
    assert config in candidates_for(family, shape)
    assert entry["us_per_call"] > 0 and entry["candidates_swept"] >= 1
    assert entry["backend"] == "cpu" and entry["dtype"] == "float32"
    total = entry["candidates_swept"] + entry["candidates_pruned"]
    assert total == len(candidates_for(family, shape))


def test_sweep_dtypes():
    cuda = torch.device("cuda")  # only named: nothing runs on it
    assert sweep_dtype("flash_decode", None, cuda) == "bfloat16"
    assert sweep_dtype("sdca", None, cuda) == "float32"
    assert sweep_dtype("ssm_scan", None, cuda) == "bfloat16"
    assert sweep_dtype("ssm_scan", torch.float32, cuda) == "float32"
    assert sweep_dtype("flash_decode", None, CPU) == "float32"
    assert sweep_dtype("sdca", "bfloat16", CPU) == "bfloat16"
    for family, dtype in (("sdca", "bfloat16"), ("flash_decode", "float32"),
                          ("flash_attention", torch.float32)):
        with pytest.raises(ValueError, match="takes"):
            sweep_dtype(family, dtype, cuda)


def test_tune_cli_on_the_cpu_second_run_hits_the_cache(tmp_path, capsys):
    from repro_torch.kernels.tune.__main__ import main

    argv = ["--preset", "smoke", "--device", "cpu", "--iters", "1", "--families",
            "flash_decode", "ssm_scan", "--cache", str(tmp_path / "t.json"), "--telemetry"]
    first = main(argv)
    out = capsys.readouterr().out
    assert "2 swept now, 0 from the cache" in out and "tune/flash_decode/" in out
    assert main(argv) == first
    assert "0 swept now, 2 from the cache" in capsys.readouterr().out


# ---------------------------------------------------------------- roofline
@pytest.mark.parametrize("preset", list(SWEEP_SHAPES))
@pytest.mark.parametrize("family", FAMILIES)
def test_candidates_and_flops_match_reference(preset, family):
    """The reference's candidates and FLOPs, but for ``ssm_scan``, whose
    knob is K4's channels a block where the reference sweeps ``chunk``
    (sweep.py's docstring); its FLOPs depend on the shape alone in both."""
    shape = SWEEP_SHAPES[preset][family]
    cands = candidates_for(family, shape)
    ref_cands = ref_tune.candidates_for(family, shape)
    if family == "ssm_scan":
        assert cands == [{"d_block": c} for c in ss_ops.KERNEL_D_BLOCKS]
        assert ref_cands and all(set(c) == {"chunk"} for c in ref_cands)
    else:
        assert cands == ref_cands
    for config, ref_config in zip(cands, ref_cands * len(cands) if family == "ssm_scan"
                                  else ref_cands):
        assert estimate(family, shape, config).flops == ref_estimate(family, shape,
                                                                     ref_config).flops


def test_bytes_use_the_measured_itemsize():
    shape = SWEEP_SHAPES["full"]["flash_attention"]
    f32 = estimate("flash_attention", shape, {"block_q": 16, "block_k": 64}, "float32")
    bf16 = estimate("flash_attention", shape, {"block_q": 16, "block_k": 64}, torch.bfloat16)
    assert f32.bytes_moved == 2 * bf16.bytes_moved
    assert f32.bytes_moved == ref_estimate("flash_attention", shape,
                                           {"block_q": 16, "block_k": 64}).bytes_moved


@pytest.mark.parametrize("family, config", [("flash_decode", {"block_k": 64}),
                                            ("flash_decode_paged", {"pages_per_program": 4})])
@pytest.mark.parametrize("preset", list(SWEEP_SHAPES))
def test_decode_bytes_count_the_valid_positions(family, config, preset):
    """K2 and K5 stop at each row's length, and the sweep feeds them
    ragged_lengths: their bytes are the reference's whole-cache bytes times
    the valid share, in the measured dtype's itemsize."""
    shape = SWEEP_SHAPES[preset][family]
    b = shape["b"]
    s = shape["s"] if family == "flash_decode" else shape["npp"] * shape["page"]
    share = float(ragged_lengths(b, s).sum()) / (b * s)
    assert share < 0.6
    f32 = estimate(family, shape, config, "float32")
    assert f32.bytes_moved == 2 * estimate(family, shape, config, torch.bfloat16).bytes_moved
    assert f32.bytes_moved == pytest.approx(
        share * ref_estimate(family, shape, config).bytes_moved, rel=1e-12)


def test_roofline_prune_fits_and_slack():
    shape = {"b": 1, "h": 2, "s": 4096, "d": 128}
    cands = candidates_for("flash_attention", shape)
    kept, n_pruned = prune("flash_attention", shape, cands, "bfloat16")
    assert kept and n_pruned + len(kept) == len(cands)
    for est in kept:
        assert est.fits and est.smem_bytes <= MAX_SMEM_PER_BLOCK
        assert est.config["block_k"] <= 64  # K3 keeps one key tile of at most 64
    t_best = min(e.t_model_s for e in kept)
    assert all(e.t_model_s <= 3.0 * t_best + 1e-12 for e in kept)


@pytest.mark.parametrize("preset", list(SWEEP_SHAPES))
def test_prune_times_candidates_differing_only_in_ignored_keys_once(preset):
    """K3's rows do not depend on block_q: each block_k is timed once, with
    the first block_q of the reference's candidate list."""
    shape = SWEEP_SHAPES[preset]["flash_attention"]
    cands = candidates_for("flash_attention", shape)
    kept, n_pruned = prune("flash_attention", shape, cands, "bfloat16")
    block_ks = [e.config["block_k"] for e in kept]
    assert kept and len(block_ks) == len(set(block_ks))
    assert all(e.config["block_q"] == cands[0]["block_q"] for e in kept)
    assert n_pruned + len(kept) == len(cands)


def test_roofline_never_keeps_what_a_kernel_refuses():
    shape = {"b": 8, "h": 40, "s": 1088, "d": 128}  # K5: a 512-position tile is 278 KB
    kept, _ = prune("flash_decode", shape, candidates_for("flash_decode", shape), "bfloat16")
    assert kept and max(e.config["block_k"] for e in kept) <= 256
    shape = {"b": 8, "hk": 8, "g": 5, "d": 128, "page": 16, "npp": 68}
    kept, _ = prune("flash_decode_paged", shape, candidates_for("flash_decode_paged", shape))
    assert kept and max(e.config["pages_per_program"] for e in kept) <= 16
    with pytest.raises(ValueError, match="takes none"):
        shape = {"b": 1, "h": 1, "s": 64, "d": 8192}
        prune("flash_decode", shape, candidates_for("flash_decode", shape))


def test_roofline_estimates_monotone_in_work():
    small = estimate("flash_decode_paged", {"b": 1, "hk": 1, "g": 1, "d": 16, "page": 8,
                                            "npp": 4}, {"pages_per_program": 2})
    big = estimate("flash_decode_paged", {"b": 4, "hk": 4, "g": 2, "d": 64, "page": 16,
                                          "npp": 128}, {"pages_per_program": 2})
    assert big.flops > small.flops and big.bytes_moved > small.bytes_moved
    assert light_speed_s(big.flops, big.bytes_moved) > light_speed_s(small.flops,
                                                                     small.bytes_moved)
    # a launch's blocks run side by side: more blocks than SMs add a wave
    one = estimate("flash_decode", {"b": 1, "h": 132, "s": 64, "d": 16}, {"block_k": 64})
    two = estimate("flash_decode", {"b": 1, "h": 133, "s": 64, "d": 16}, {"block_k": 64})
    assert (one.serial_steps, two.serial_steps) == (1, 2)


def test_roofline_follows_the_redesigned_k1_and_k4():
    """K1: one warp a worker, its ring of rows (and v past d 2048) in shared
    memory, as many workers an SM as their rings fit.  K4: the prefill body's
    staging per d_block, a warp walking its channels' 256-position tiles in
    order; the decode body (S = 1) stages nothing."""
    from repro_torch.kernels.sdca import ops as sdca_ops

    k1 = estimate("sdca", {"m": 16, "nl": 3750, "d": 784, "h": 3750}, {"use_pallas": 1})
    assert k1.fits and k1.smem_bytes == sdca_ops.kernel_plan(784)[2] == 51328
    assert k1.serial_steps == 3750  # 16 workers: one wave of H steps
    per_sm = MAX_SMEM_PER_BLOCK // 51328  # 4 rings an SM
    many = estimate("sdca", {"m": 132 * per_sm + 1, "nl": 64, "d": 784, "h": 64},
                    {"use_pallas": 1})
    assert many.serial_steps == 2 * 64
    assert roofline_mod.k1_smem_bytes(2049) == sdca_ops.kernel_plan(2049)[2] == 128 + 5 * 128 * 65
    wide = {"m": 1, "nl": 8, "d": sdca_ops.MAX_D + 1, "h": 8}
    assert not estimate("sdca", wide, {"use_pallas": 1}).fits
    assert estimate("sdca", wide, {"use_pallas": 0}).fits
    assert estimate("sdca", {**wide, "d": sdca_ops.MAX_D}, {"use_pallas": 1}).fits

    prefill = {"bt": 1, "s": 1024, "dn": 8192, "n": 16}
    for d_block in ss_ops.KERNEL_D_BLOCKS:
        e = estimate("ssm_scan", prefill, {"d_block": d_block}, "bfloat16")
        assert e.fits and e.smem_bytes == roofline_mod.k4_smem_bytes(16, d_block)
    e16 = estimate("ssm_scan", prefill, {"d_block": 16}, "bfloat16")
    assert e16.smem_bytes == ((2 * 16 + 2 * 16) * 292 + 2 * 16 * 16) * 4
    # 512 blocks, 3 an SM: 2 waves x 4 tiles x 2 channels a warp
    assert e16.serial_steps == 2 * 4 * 2
    decode = estimate("ssm_scan", {"bt": 8, "s": 1, "dn": 8192, "n": 16}, {"d_block": 16})
    assert decode.smem_bytes == 0 and decode.serial_steps == 2  # 256 blocks of 256 threads
    assert not estimate("ssm_scan", prefill, {"d_block": 12}).fits
    assert not estimate("ssm_scan", {**prefill, "n": 3}, {"d_block": 16}).fits
    assert roofline_mod.k4_smem_bytes(32, 32) <= MAX_SMEM_PER_BLOCK


# K2's MLA latent form at deepseek-v2-236b's decode shape: the reference's
# key (one KV head, all 128 heads on it, d = kv_lora_rank) with the rope width
LATENT = fd_ops.latent_shape(8, 128, 512, 64, 16, 68)


def test_latent_roofline_counts_the_q_pe_term():
    """FLOPs: the reference's count at its key (q . k and p . v over r) plus
    the q_pe . kpe term over dr; bytes: each valid position's latent and
    rope rows read once (one pool is the keys and the values)."""
    config = {"pages_per_program": 4}
    ref_key = {k: v for k, v in LATENT.items() if k != "dr"}
    b, h, s, dr = LATENT["b"], LATENT["g"], LATENT["npp"] * LATENT["page"], LATENT["dr"]
    est = estimate("flash_decode_paged", LATENT, config, torch.bfloat16)
    assert est.flops == ref_estimate("flash_decode_paged", ref_key, config).flops \
        + 2.0 * b * h * s * dr
    assert est.bytes_moved == float(ragged_lengths(b, s).sum()) * (512 + 64) * 2
    assert est.smem_bytes == roofline_mod.latent_smem_bytes(512, 64)


def test_latent_roofline_refuses_the_blockings_the_wrapper_refuses():
    """The roofline keeps a pages_per_program at the latent shape exactly
    when the wrapper takes it.  The latent kernel's tile is 64 positions
    whatever pages_per_program is, so its shared memory (its own formula,
    mirrored; held equal to the kernel's export on the card,
    tests/test_torch_mla_gpu.py) is the same 221,952 bytes for every
    candidate and fits a block: the roofline keeps them all, and prune times
    one, since the kernel does not depend on the key.  Widths the kernel is
    not built for are refused."""
    cands = candidates_for("flash_decode_paged", LATENT)
    for c in cands:
        est = estimate("flash_decode_paged", LATENT, c, "bfloat16")
        assert est.fits and est.smem_bytes == roofline_mod.latent_smem_bytes(512, 64)
    assert roofline_mod.latent_smem_bytes(512, 64) == 221952 <= MAX_SMEM_PER_BLOCK
    kept, pruned = prune("flash_decode_paged", LATENT, cands, "bfloat16")
    assert len(kept) == 1 and pruned == len(cands) - 1
    assert kept[0].config == cands[0]
    with pytest.raises(ValueError, match="takes none"):  # widths the kernel is not built for
        shape = dict(LATENT, d=256)
        prune("flash_decode_paged", shape, candidates_for("flash_decode_paged", shape))


def test_latent_decode_reads_the_tuned_pages_per_program(default_cache_at):
    """``pages_per_program=None`` reads the cache at ``latent_shape`` (a miss
    gives the default); the sweep times the latent form on the CPU's plain
    version."""
    rng = np.random.RandomState(3)
    args = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for shape in ((2, 4, 16), (2, 4, 8), (9, 4, 16), (9, 4, 8))]
    args += [torch.tensor([13, 30], dtype=torch.int32),
             torch.from_numpy(rng.permutation(np.arange(1, 9)).reshape(2, 4).astype(np.int32))]
    shape = fd_ops.latent_shape(2, 4, 16, 8, 4, 4)

    def call(ppp=None):
        return fd_ops.paged_latent_decode_attention(*args, sm_scale=0.2, impl="stream",
                                                    pages_per_program=ppp)

    assert torch.equal(call(), call(fd_ops.DEFAULT_PAGES_PER_PROGRAM))
    cache = ConfigCache(str(default_cache_at))
    _put(cache, "flash_decode_paged", shape, {"pages_per_program": 1})
    cache.save()
    tune.reset_default_cache()
    assert torch.equal(call(), call(1))
    config = ensure("flash_decode_paged", dict(shape, b=1), device=CPU,
                    cache=ConfigCache(path=None), iters=1)
    assert config["pages_per_program"] in (1, 2, 4)


# --------------------------------------------------------------- telemetry
def _decode_entries(cache, ref=False):
    for b, us in [(1, 900.0), (2, 1100.0), (4, 1600.0), (8, 2500.0)]:
        shape = {"b": b, "hk": 2, "g": 2, "d": 32, "page": 16, "npp": 32}
        if ref:
            cache.put(ref_tune.cache_key("flash_decode_paged", shape, jnp.float32,
                                         backend="cpu"),
                      family="flash_decode_paged", shape=shape, dtype=jnp.float32,
                      config={"pages_per_program": 4}, us_per_call=us, swept=2, pruned=5,
                      backend="cpu")
        else:
            cache.put(cache_key("flash_decode_paged", shape, "float32", "cpu"),
                      family="flash_decode_paged", shape=shape, dtype="float32",
                      config={"pages_per_program": 4}, us_per_call=us, swept=2, pruned=5,
                      backend="cpu")
    return cache


def test_bench_rows_shape():
    rows = bench_rows(_decode_entries(ConfigCache(path=None)))
    assert len(rows) == 4
    name, us, derived = rows[0]
    assert name.startswith("tune/flash_decode_paged/")
    assert us > 0 and "pages_per_program=4" in derived
    assert "swept=2" in derived and "pruned=5" in derived and "x_lightspeed=" in derived


def test_planner_fitted_from_tune_events_matches_reference():
    """The port's planner, seeded from the port's tune events, gives the
    reference planner's step times on the same entries."""
    ours, theirs = CapacityPlanner(), RefPlanner()
    events = tune_events(_decode_entries(ConfigCache(path=None)))
    assert ours.ingest(events, n_layers=4, overhead_s=1e-4) == 4
    ref_events = ref_tune.tune_events(_decode_entries(ref_tune.ConfigCache(path=None), True))
    assert theirs.ingest(ref_events, n_layers=4, overhead_s=1e-4) == 4
    ours.fit()
    theirs.fit()
    for b in (1, 2, 4, 8, 16):
        assert ours.step_time(b) == pytest.approx(theirs.step_time(b), rel=1e-6)
    assert ours.step_time(4) == pytest.approx(4 * 1.6e-3 + 1e-4, rel=0.2)


def test_decode_step_rows_is_deprecated():
    from repro_torch.telemetry import reset_deprecation_warnings

    reset_deprecation_warnings()
    with pytest.warns(DeprecationWarning):
        rows = decode_step_rows(_decode_entries(ConfigCache(path=None)))
    assert sorted(r["batch"] for r in rows) == [1, 2, 4, 8]


# ------------------------------------------------------------ tuned hooks
def _paged_inputs():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 2, 8).astype(np.float32))
    kp = torch.from_numpy(rng.randn(9, 2, 4, 8).astype(np.float32))
    vp = torch.from_numpy(rng.randn(9, 2, 4, 8).astype(np.float32))
    pt = torch.from_numpy(rng.randint(0, 9, (2, 4)).astype(np.int32))
    return q, kp, vp, torch.tensor([3, 14], dtype=torch.int32), pt


def test_tuned_pages_per_program_feeds_paged_decode(default_cache_at):
    shape = {"b": 2, "hk": 2, "g": 1, "d": 8, "page": 4, "npp": 4}
    args = (2, 2, 2, 8, 4, 4, torch.float32, "cpu")
    assert fd_ops.pages_per_program_for(*args) == 4  # a miss: the default
    cache = ConfigCache(str(default_cache_at))
    _put(cache, "flash_decode_paged", shape, {"pages_per_program": 2})
    cache.save()
    tune.reset_default_cache()
    assert fd_ops.pages_per_program_for(*args) == 2
    assert fd_ops.pages_per_program_for(*args[:-1], "cuda") == 4  # another device's key
    inputs = _paged_inputs()
    tuned = fd_ops.paged_decode_attention(*inputs, impl="stream")
    explicit = fd_ops.paged_decode_attention(*inputs, impl="stream", pages_per_program=2)
    assert torch.equal(tuned, explicit)


def test_runtime_resolves_pages_per_program_from_the_cache(default_cache_at):
    """``Runtime()`` leaves pages_per_program to the cache: a smoke LM's paged
    decode with the default Runtime gives the bits of one run at the tuned
    value named explicitly."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import LM
    from repro_torch.models.runtime import Runtime
    from repro_torch.serve.cache import init_paged_cache, write_prefill

    assert Runtime().pages_per_program is None
    cfg = get_smoke_config("qwen3-14b")
    lm = LM(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 37)))
    tables = torch.tensor([[3, 7, 1, 10], [5, 2, 11, 8]], dtype=torch.int32)
    shape = {"b": 2, "hk": cfg.n_kv_heads, "g": cfg.n_heads // cfg.n_kv_heads,
             "d": cfg.head_dim, "page": 16, "npp": 4}
    cache = ConfigCache(str(default_cache_at))
    _put(cache, "flash_decode_paged", shape, {"pages_per_program": 1}, dtype=cfg.dtype)
    cache.save()
    tune.reset_default_cache()

    def decode(rt):
        kv = init_paged_cache(lm, num_pages=12, page_size=16, max_batch=2)
        for slot, n in enumerate((37, 21)):
            _, pre = lm.prefill(prompt[:, :n])
            write_prefill(kv, pre, slot=slot, page_ids=list(tables[slot, :-(-n // 16)]),
                          page_size=16)
        lengths = torch.tensor([37, 21], dtype=torch.int32)
        return lm.decode_step_paged(torch.tensor([5, 9]), lengths, kv, tables, rt=rt)[0]

    assert torch.equal(decode(Runtime()), decode(Runtime(pages_per_program=1)))


def test_tuned_block_k_reaches_decode_attention_auto(default_cache_at):
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 4, 40, 16).astype(np.float32))
    v = torch.from_numpy(rng.randn(2, 4, 40, 16).astype(np.float32))
    lens = torch.tensor([40, 17], dtype=torch.int32)
    cache = ConfigCache(str(default_cache_at))
    _put(cache, "flash_decode", {"b": 2, "h": 4, "s": 40, "d": 16}, {"block_k": 16})
    cache.save()
    tune.reset_default_cache()
    tuned = fd_ops.decode_attention_auto(q, k, v, lens, tuned=True)
    assert torch.equal(tuned, fd_ops.decode_attention_auto(q, k, v, lens, block_k=16))


def test_tuned_chunk_reaches_selective_scan(default_cache_at):
    """The tuner's ssm_scan knob is K4's channels a block (``d_block``): a
    cache entry reaches the wrapper, a miss keeps the value given; ``chunk``
    stays in the signature and changes nothing; both are checked."""
    rng = np.random.RandomState(2)
    bt, s, dn, n = 1, 24, 8, 4
    x = torch.from_numpy(rng.randn(bt, s, dn).astype(np.float32))
    dt = torch.from_numpy(np.abs(rng.randn(bt, s, dn)).astype(np.float32) * 0.1)
    A = -torch.arange(1, n + 1, dtype=torch.float32).expand(dn, n).contiguous()
    B = torch.from_numpy(rng.randn(bt, s, n).astype(np.float32))
    C = torch.from_numpy(rng.randn(bt, s, n).astype(np.float32))
    D = torch.ones(dn)
    assert ss_ops.scan_d_block(x, A, 16, tuned=True) == 16  # a miss keeps the value given
    cache = ConfigCache(str(default_cache_at))
    _put(cache, "ssm_scan", {"bt": bt, "s": s, "dn": dn, "n": n}, {"d_block": 32})
    cache.save()
    tune.reset_default_cache()
    assert ss_ops.scan_d_block(x, A, 16, tuned=True) == 32
    assert ss_ops.scan_d_block(x, A, 16, tuned=False) == 16
    tuned = ss_ops.selective_scan(x, dt, A, B, C, D, tuned=True)
    plain = ss_ops.selective_scan(x, dt, A, B, C, D, chunk=16, d_block=8)
    assert all(torch.equal(a, b) for a, b in zip(tuned, plain))
    with pytest.raises(ValueError, match="chunk"):
        ss_ops.selective_scan(x, dt, A, B, C, D, chunk=0)
    with pytest.raises(ValueError, match="d_block"):
        ss_ops.selective_scan(x, dt, A, B, C, D, d_block=12)


def test_local_sdca_use_kernel_and_tuned(default_cache_at):
    from repro_torch.kernels.sdca import ops as sdca_ops
    from repro_torch.kernels.sdca.ref import local_sdca_ref

    rng = np.random.RandomState(3)
    m, nl, d = 2, 16, 8
    X = torch.from_numpy(rng.randn(m, nl, d).astype(np.float32))
    y = torch.from_numpy(np.sign(rng.randn(m, nl)).astype(np.float32))
    a, w = torch.zeros(m, nl), torch.zeros(d)
    idx = torch.from_numpy(np.stack([rng.permutation(nl) for _ in range(m)]))
    want = local_sdca_ref(X, y, a, w, idx, 1.0, 1e-3, float(m * nl))
    cache = ConfigCache(str(default_cache_at))
    _put(cache, "sdca", {"m": m, "nl": nl, "d": d, "h": nl}, {"use_pallas": 0})
    cache.save()
    tune.reset_default_cache()
    for kw in ({"use_kernel": False}, {"tuned": True}, {}):
        got = sdca_ops.local_sdca(X, y, a, w, idx, 1.0, 1e-3, float(m * nl), **kw)
        assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert sdca_ops.local_sdca.launches == 0


def test_serve_cli_seeds_the_planner_from_a_tune_cache(tmp_path, monkeypatch, capsys):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve

    cfg = get_smoke_config("qwen3-14b")
    path = tmp_path / "cli.json"
    cache = ConfigCache(str(path))
    for b, us in ((1, 50.0), (2, 60.0), (4, 80.0)):
        shape = {"b": b, "hk": cfg.n_kv_heads, "g": cfg.n_heads // cfg.n_kv_heads,
                 "d": cfg.head_dim, "page": 16, "npp": 6}
        _put(cache, "flash_decode_paged", shape, {"pages_per_program": 2}, cfg.dtype, us=us)
    cache.save()
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "unused.json"))
    try:
        result = serve.main(["--smoke", "--continuous", "--device", "cpu",
                             "--tune-cache", str(path)])
    finally:
        tune.reset_default_cache()
    out = capsys.readouterr().out
    assert f"seeded with 3 measured kernel row(s) from {path} (x{cfg.n_layers} layers)" in out
    assert "pages_per_program=2 at b=4" in out and "(tuned)" in out
    assert "bit_identical=yes" in out
    assert result["tune_rows"] == 3 and result["pages_per_program"] == 2
    assert result["served"] == result["requests"] == 8
