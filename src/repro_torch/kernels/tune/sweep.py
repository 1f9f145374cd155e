"""Sweep harness: measure surviving candidates, persist the winner.

``sweep`` builds a real invocation of the kernel family at the requested
shape, times every candidate config that survives roofline pruning
(``tune.roofline``), and records the fastest in the config cache.
``ensure`` is the memoized entry point: a cache hit returns immediately
without re-sweeping (``ConfigCache.sweeps`` counts the sweeps).

Each case calls the port's model-facing wrapper, so on the card every family
times its hand-written kernel (K3 for ``flash_attention`` and
``prefill_chunk``, K5 for ``flash_decode``, K2 for ``flash_decode_paged``
(its latent form for a shape with a rope width ``dr``),
K4 for ``ssm_scan``, K1 or its plain version for ``sdca``'s two candidates),
and a kernel that fails to build or launch fails the sweep: nothing is timed
through a plain version in its place.  On the CPU the same calls run the
plain versions.  Entries are keyed by the device type, so the two never mix.
Inputs come from seeded ``torch.Generator``s (the reference's PRNG bits are
not reproduced).  On the card a candidate's ``us_per_call`` is device time,
from CUDA events around back-to-back calls (``device_time_fn``): the
dry-run turns it into a cell's measured kernel time
(``repro_torch.launch.dryrun.attach_tuned_kernels``); the host's wall clock
a call, which adds the wrapper's launch time, stays beside it as
``wall_us_per_call``, timed over the same calls.  On the CPU both are the
wall clock.

Every family sweeps the reference's candidates but ``ssm_scan``: the
reference sweeps ``chunk``, which groups its associative scan's terms, while
K4's grouping in time is fixed (tiles of 256 positions from position 0), so
the port sweeps K4's channels a block (``d_block`` 8, 16, 32), which leaves
every sum's grouping, and so every bit, as it is.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ssm_scan.ops import KERNEL_D_BLOCKS as K4_D_BLOCKS
from repro_torch.kernels.tune import roofline
from repro_torch.kernels.tune.cache import ConfigCache, cache_key, dtype_name
from repro_torch.kernels.tune.roofline import ragged_lengths
from repro_torch.telemetry import TuneEvent, default_tracker

FAMILIES = (
    "flash_attention",
    "flash_decode",
    "flash_decode_paged",
    "prefill_chunk",
    "ssm_scan",
    "sdca",
)

# default sweep shapes: "full" targets serving-scale caches, "smoke" keeps
# the CI sweep to tens of milliseconds
SWEEP_SHAPES: Dict[str, Dict[str, Dict[str, int]]] = {
    "full": {
        "flash_attention": {"b": 1, "h": 8, "s": 1024, "d": 64},
        "flash_decode": {"b": 4, "h": 8, "s": 512, "d": 64},
        "flash_decode_paged": {"b": 4, "hk": 4, "g": 2, "d": 64, "page": 16, "npp": 128},
        "prefill_chunk": {"p": 512, "hk": 4, "g": 2, "d": 64, "page": 16, "npp": 64},
        "ssm_scan": {"bt": 2, "s": 512, "dn": 64, "n": 16},
        "sdca": {"m": 4, "nl": 256, "d": 64, "h": 256},
    },
    "smoke": {
        "flash_attention": {"b": 1, "h": 2, "s": 64, "d": 16},
        "flash_decode": {"b": 2, "h": 2, "s": 64, "d": 16},
        "flash_decode_paged": {"b": 2, "hk": 2, "g": 2, "d": 16, "page": 8, "npp": 8},
        "prefill_chunk": {"p": 32, "hk": 2, "g": 2, "d": 16, "page": 8, "npp": 8},
        "ssm_scan": {"bt": 1, "s": 64, "dn": 8, "n": 4},
        "sdca": {"m": 2, "nl": 32, "d": 16, "h": 32},
    },
}

# The dtypes each family's kernel takes on the card; the first is the one a
# sweep on the card measures unless told otherwise (K4 takes both and is
# served in bf16).  On the CPU the reference's float32 is the default.
KERNEL_DTYPES: Dict[str, Tuple[str, ...]] = {
    "flash_attention": ("bfloat16",),
    "flash_decode": ("bfloat16",),
    "flash_decode_paged": ("bfloat16",),
    "prefill_chunk": ("bfloat16",),
    "ssm_scan": ("bfloat16", "float32"),
    "sdca": ("float32",),
}


def sweep_dtype(family: str, dtype, device: torch.device) -> str:
    """The dtype a sweep of ``family`` on ``device`` measures: ``dtype`` when
    given (on the card, one its kernel takes, else this raises), else the
    kernel's own on the card and float32 on the CPU."""
    if dtype is None:
        return KERNEL_DTYPES[family][0] if device.type == "cuda" else "float32"
    name = dtype_name(dtype)
    if device.type == "cuda" and name not in KERNEL_DTYPES[family]:
        raise ValueError(f"the {family} kernel takes {KERNEL_DTYPES[family]}, not {name}")
    return name


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def time_fn(fn: Callable, *args, iters: int = 5) -> float:
    """Host wall-clock microseconds per call: one warm-up call, then the mean
    of ``iters`` calls, each followed by ``torch.cuda.synchronize()`` when an
    argument lies on the card."""
    on_card = _on_card(args)

    def call():
        fn(*args)
        if on_card:
            torch.cuda.synchronize()

    call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) / iters * 1e6


def device_time_fn(fn: Callable, *args, iters: int = 5) -> Tuple[float, float]:
    """(microseconds a call on the device that runs it, microseconds a call
    by the host's wall clock) over the same ``iters`` calls back to back
    after one warm-up call: on the card CUDA events bound the calls (the
    device's time, which the host's launch time overlaps) and the wall clock
    runs from the first call to the last one's end; on the CPU both are the
    wall clock (``time_fn``)."""
    if not _on_card(args):
        us = time_fn(fn, *args, iters=iters)
        return us, us
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    return start.elapsed_time(end) / iters * 1e3, wall / iters * 1e6


def _pow2_range(lo: int, hi: int) -> List[int]:
    out, v = [], lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


def candidates_for(family: str, shape: Dict[str, int]) -> List[Dict[str, int]]:
    if family == "flash_attention":
        s = shape["s"]
        blocks = [v for v in _pow2_range(16, 512) if v <= max(s, 16)]
        return [{"block_q": bq, "block_k": bk} for bq in blocks for bk in blocks]
    if family == "flash_decode":
        s = shape["s"]
        return [{"block_k": bk} for bk in _pow2_range(16, 1024) if bk <= max(s, 16)]
    if family == "flash_decode_paged":
        npp = shape["npp"]
        return [{"pages_per_program": p} for p in _pow2_range(1, 128) if p <= npp]
    if family == "prefill_chunk":
        p = shape["p"]
        return [{"chunk": c} for c in _pow2_range(16, 512) if c <= max(p, 16)]
    if family == "ssm_scan":
        return [{"d_block": c} for c in K4_D_BLOCKS]
    if family == "sdca":
        return [{"use_pallas": 0}, {"use_pallas": 1}]
    raise ValueError(f"unknown kernel family {family!r}")


# ---------------------------------------------------------------------------
# Per-family measurable cases: each returns build(config) -> (fn, args)
# ---------------------------------------------------------------------------
LATENT_SWEEP_SCALE = 192 ** -0.5


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def _case_flash_attention(shape, dtype, device):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    b, h, s, d = shape["b"], shape["h"], shape["s"], shape["d"]
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (_randn(gen, (b, h, s, d), dtype) for _ in range(3))

    def build(config):
        return functools.partial(flash_attention, causal=True, **config), (q, k, v)

    return build


def _case_flash_decode(shape, dtype, device):
    from repro_torch.kernels.flash_decode.ops import decode_attention_auto

    b, h, s, d = shape["b"], shape["h"], shape["s"], shape["d"]
    gen = torch.Generator(device=device).manual_seed(1)
    q = _randn(gen, (b, h, d), dtype)
    kc, vc = _randn(gen, (b, h, s, d), dtype), _randn(gen, (b, h, s, d), dtype)
    lens = torch.from_numpy(ragged_lengths(b, s)).to(device)

    def build(config):
        fn = functools.partial(decode_attention_auto, use_kernel=True,
                               block_k=config["block_k"])
        return fn, (q, kc, vc, lens)

    return build


def _random_tables(gen, b: int, npp: int, n_pages: int) -> torch.Tensor:
    """Rows of ``npp`` distinct pages drawn from 1.. (page 0 is the scratch
    page), out of order."""
    rows = [torch.randperm(n_pages - 1, generator=gen, device=gen.device)[:npp] + 1
            for _ in range(b)]
    return torch.stack(rows).to(torch.int32)


def _case_flash_decode_paged(shape, dtype, device):
    from repro_torch.kernels.flash_decode.ops import paged_decode_attention

    if "dr" in shape:  # K2's MLA latent form (flash_decode.ops.latent_shape)
        return _case_latent_decode(shape, dtype, device)
    b, hk, g, d = shape["b"], shape["hk"], shape["g"], shape["d"]
    page, npp = shape["page"], shape["npp"]
    n_pages = b * npp + 1
    gen = torch.Generator(device=device).manual_seed(2)
    q = _randn(gen, (b, hk * g, d), dtype)
    kp = _randn(gen, (n_pages, hk, page, d), dtype)
    vp = _randn(gen, (n_pages, hk, page, d), dtype)
    pt = _random_tables(gen, b, npp, n_pages)
    lens = torch.from_numpy(ragged_lengths(b, npp * page)).to(device)

    def build(config):
        fn = functools.partial(paged_decode_attention, impl="kernel",
                               pages_per_program=config["pages_per_program"])
        return fn, (q, kp, vp, lens, pt)

    return build


def _case_latent_decode(shape, dtype, device):
    """K2's latent form at ``{b, hk: 1, g: H, d: r, dr, page, npp}``: absorbed
    queries and rope queries over one latent and one rope pool, scaled as
    DeepSeek-V2's MLA (1 / sqrt(192), a fixed yardstick)."""
    from repro_torch.kernels.flash_decode.ops import paged_latent_decode_attention

    b, h, r, dr = shape["b"], shape["g"], shape["d"], shape["dr"]
    page, npp = shape["page"], shape["npp"]
    n_pages = b * npp + 1
    gen = torch.Generator(device=device).manual_seed(2)
    q_lat, q_pe = _randn(gen, (b, h, r), dtype), _randn(gen, (b, h, dr), dtype)
    ckv = _randn(gen, (n_pages, page, r), dtype)
    kpe = _randn(gen, (n_pages, page, dr), dtype)
    pt = _random_tables(gen, b, npp, n_pages)
    lens = torch.from_numpy(ragged_lengths(b, npp * page)).to(device)

    def build(config):
        fn = functools.partial(paged_latent_decode_attention, sm_scale=LATENT_SWEEP_SCALE,
                               impl="kernel", pages_per_program=config["pages_per_program"])
        return fn, (q_lat, q_pe, ckv, kpe, lens, pt)

    return build


def _case_prefill_chunk(shape, dtype, device):
    """Whole-prompt chunked prefill at chunk width C: ceil(p/C) calls of the
    paged-prefill flash path (gather the page row, attend with static
    q_offset).  Small chunks pay repeated page-row gathers and launches;
    large chunks pay step latency — the tunable is that knee.  The timed fn
    drives every chunk so candidates are compared on full-prompt cost, not
    per-call cost."""
    from repro_torch.kernels.flash_decode.ops import paged_prefill_attention

    p, hk, g, d = shape["p"], shape["hk"], shape["g"], shape["d"]
    page, npp = shape["page"], shape["npp"]
    n_pages = npp + 1
    gen = torch.Generator(device=device).manual_seed(5)
    kp = _randn(gen, (n_pages, hk, page, d), dtype)
    vp = _randn(gen, (n_pages, hk, page, d), dtype)
    pt = _random_tables(gen, 1, npp, n_pages)

    def build(config):
        c = config["chunk"]
        calls = []
        for i in range(-(-p // c)):
            s0 = i * c
            q = _randn(gen, (1, hk * g, c, d), dtype)
            lens = torch.tensor([min(s0 + c, p)], dtype=torch.int32, device=device)
            calls.append((functools.partial(paged_prefill_attention, q_offset=s0), q, lens))

        def run(kp_, vp_, pt_):
            out = None
            for fn, q, lens in calls:
                out = fn(q, kp_, vp_, lens, pt_)
            return out

        return run, (kp, vp, pt)

    return build


def _case_ssm_scan(shape, dtype, device):
    from repro_torch.kernels.ssm_scan.ops import selective_scan

    bt, s, dn, n = shape["bt"], shape["s"], shape["dn"], shape["n"]
    gen = torch.Generator(device=device).manual_seed(3)
    x = _randn(gen, (bt, s, dn), dtype)
    dt = torch.nn.functional.softplus(_randn(gen, (bt, s, dn), torch.float32))
    A = -_randn(gen, (dn, n), torch.float32).abs() - 0.1
    B = _randn(gen, (bt, s, n), dtype)
    C = _randn(gen, (bt, s, n), dtype)
    D = torch.full((dn,), 0.4, device=device)

    def build(config):
        def run(*args):
            return selective_scan(*args, d_block=config["d_block"])[0]

        return run, (x, dt, A, B, C, D)

    return build


def _case_sdca(shape, dtype, device):
    from repro_torch.kernels.sdca.ops import local_sdca

    m, nl, d, h = shape["m"], shape["nl"], shape["d"], shape["h"]
    gen = torch.Generator(device=device).manual_seed(4)
    X = _randn(gen, (m, nl, d), dtype)
    y = torch.sign(_randn(gen, (m, nl), dtype))
    a = torch.zeros((m, nl), dtype=dtype, device=device)
    w = torch.zeros((d,), dtype=dtype, device=device)
    idx = torch.stack([torch.randperm(nl, generator=gen, device=device)[:h]
                       for _ in range(m)]).to(torch.int32)

    def build(config):
        use_kernel = bool(config["use_pallas"])

        def run(*args):
            return local_sdca(*args, 1.0, 1e-3, float(m * nl), use_kernel=use_kernel)

        return run, (X, y, a, w, idx)

    return build


_CASES = {
    "flash_attention": _case_flash_attention,
    "flash_decode": _case_flash_decode,
    "flash_decode_paged": _case_flash_decode_paged,
    "prefill_chunk": _case_prefill_chunk,
    "ssm_scan": _case_ssm_scan,
    "sdca": _case_sdca,
}


def measured_call(family: str, shape: Dict[str, int], dtype, device: torch.device,
                  config: Dict[str, int]) -> Tuple[Callable, tuple]:
    """The (fn, args) the sweep times for one candidate: ``fn(*args)`` is one
    call of the family's model-facing wrapper."""
    return _CASES[family](shape, getattr(torch, dtype_name(dtype)), device)(config)


# ---------------------------------------------------------------------------
# Sweep + memoized entry point
# ---------------------------------------------------------------------------
def sweep(
    family: str,
    shape: Dict[str, int],
    dtype=None,
    *,
    device: DeviceLike = None,
    cache: Optional[ConfigCache] = None,
    iters: int = 5,
    slack: float = roofline.PRUNE_SLACK,
) -> Tuple[Dict[str, int], Dict]:
    """Measure the pruned candidate set on ``device`` (the card unless the
    caller names the CPU); store and return the winner."""
    if cache is None:
        from repro_torch.kernels.tune import default_cache

        cache = default_cache()
    dev = resolve_device(device)
    name = sweep_dtype(family, dtype, dev)
    cache.sweeps += 1
    build = _CASES[family](shape, getattr(torch, name), dev)
    kept, n_pruned = roofline.prune(family, shape, candidates_for(family, shape), name,
                                    slack=slack)
    results = []
    for est in kept:
        fn, args = build(est.config)
        us, wall = device_time_fn(fn, *args, iters=iters)
        results.append((us, est.config, wall))
    best_us, best_config, wall_us = min(results, key=lambda r: r[0])
    entry = cache.put(
        cache_key(family, shape, name, dev.type),
        family=family,
        shape=shape,
        dtype=name,
        config=best_config,
        us_per_call=best_us,
        swept=len(kept),
        pruned=n_pruned,
        backend=dev.type,
        wall_us_per_call=wall_us,
    )
    cache.save()
    # every sweep result rides the bus: a cache with its own tracker keeps
    # the events alongside the entries, otherwise the process-wide default
    tracker = getattr(cache, "tracker", None) or default_tracker()
    tracker.emit(TuneEvent.from_legacy_row(entry))
    return best_config, entry


def ensure(
    family: str,
    shape: Dict[str, int],
    dtype=None,
    *,
    device: DeviceLike = None,
    cache: Optional[ConfigCache] = None,
    sweep_on_miss: bool = True,
    **sweep_kwargs,
) -> Optional[Dict]:
    """Cached config for the key, sweeping at most once per (shape, dtype,
    device type).  Returns None on a miss when ``sweep_on_miss=False``."""
    if cache is None:
        from repro_torch.kernels.tune import default_cache

        cache = default_cache()
    dev = resolve_device(device)
    name = sweep_dtype(family, dtype, dev)
    config = cache.config(cache_key(family, shape, name, dev.type))
    if config is not None:
        return config
    if not sweep_on_miss:
        return None
    config, _ = sweep(family, shape, name, device=dev, cache=cache, **sweep_kwargs)
    return config


def sweep_all(
    preset: str = "smoke",
    *,
    families: Sequence[str] = FAMILIES,
    dtype=None,
    device: DeviceLike = None,
    cache: Optional[ConfigCache] = None,
    iters: int = 5,
) -> List[Dict]:
    """Every family's cache entry at its preset shape, swept only where the
    cache has none (``ensure``'s memoization; ``cache.sweeps`` counts the
    sweeps run)."""
    if cache is None:
        from repro_torch.kernels.tune import default_cache

        cache = default_cache()
    dev = resolve_device(device)
    entries = []
    for family in families:
        shape = SWEEP_SHAPES[preset][family]
        name = sweep_dtype(family, dtype, dev)
        ensure(family, shape, name, device=dev, cache=cache, iters=iters)
        entries.append(cache.get(cache_key(family, shape, name, dev.type)))
    return entries
