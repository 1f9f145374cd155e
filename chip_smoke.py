#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

  python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. device: requires a CUDA card and prints its name and power limit;
  2. build:  compiles every kernel of the main path from the sources here;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card, at the main path's shapes, within the stated tolerances;
  4. small-input check: CoCoA rounds on the card against the plain version
     on the CPU, with the same coordinate orders;
  5. main path: the Hemingway loop (repro_torch.quickstart) on the paper's
     workload, 60000 x 784, m = 1..128, with the kernels' launch counts
     checked against the rounds it ran;
  6. timings: each kernel's time per launch against its bound and its plain
     version's time;
  7. device busy share of CoCoA rounds at m = 1, 16 and 128.
The last lines are one JSON object per kernel summary, the card's
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA's data sheet: HBM3 rate and float32 rate outside the
# tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Quickstart's rounds (repro_torch.quickstart.SIM_ITERS / REF_ITERS) as run here.
SIM_ITERS = 40
REF_ITERS = 150

# Kernel vs plain, for one call from the same inputs.  The two differ only in
# the order of each step's two float32 sums, and thousands of dependent steps
# compound that.  On an H100 the difference measured about 1e-6 in both a and
# dw (max |dw| about 1); the limits leave ten times that.
DW_RTOL_OF_MAX = 1e-5   # max |dw_kernel - dw_plain| <= 1e-5 * max |dw_plain|
A_ATOL = 1e-5           # max |a_kernel - a_plain|
PRIMAL_RTOL = 1e-5      # P(w + combined dw), kernel vs plain
CURVE_RTOL = 1e-4       # objective curves of the small-input check


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sdca_bytes_and_flops(m, nl, d, idx):
    """Least traffic of one local_sdca call: every X row the orders touch,
    y, a, w and idx read once; a and dw written once.  Operations: each step
    two length-d dot products and a length-d axpy with a division."""
    rows = sum(int(row.unique().numel()) for row in idx)
    h = idx.shape[1]
    nbytes = 4 * (rows * d + 3 * m * nl + d + m * h + m * d)
    flops = m * h * 7 * d
    return nbytes, flops


def main() -> None:
    import torch

    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import quickstart
    from repro_torch.kernels.sdca import build, ops
    from repro_torch.kernels.sdca.ref import local_sdca_ref
    from repro_torch.optim import CocoaConfig, make_mnist_svm, run_cocoa
    from repro_torch.convert import problem_from_numpy
    from repro_torch.optim.cocoa import draw_indices, partition
    from repro_torch.optim.problems import synthetic_mnist

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}  (torch {torch.__version__}, CUDA {torch.version.cuda})")
    dev = torch.device("cuda")

    phase("build")
    built = build.build()
    print(f"sdca.cu: built in {built['seconds']:.1f} s -> {built['path']}")
    for line in built["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    build.load()

    phase("kernel vs plain (60000 x 784 shards)")
    problem = make_mnist_svm(device=dev)
    lam, n = problem.lam, float(problem.n)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [  # name, m, loss, plus, H as a multiple of nl
        ("hinge m=16", 16, "hinge", False, 1),
        ("smooth_hinge m=16 cocoa+", 16, "smooth_hinge", True, 1),
        ("hinge m=7 padded tail", 7, "hinge", False, 1),
        ("hinge m=16 H=2nl repeats", 16, "hinge", False, 2),
    ]
    max_err = 0.0
    inputs_16 = None
    for name, m, loss, plus, hf in cases:
        Xs, ys = partition(problem.X, problem.y, m)
        nl = Xs.shape[1]
        a = torch.zeros((m, nl), device=dev)
        w = torch.zeros(problem.d, device=dev)
        idx = draw_indices(m, nl, hf * nl, gen)
        sp = float(m) if plus else 1.0
        ak, dwk = ops.local_sdca(Xs, ys, a, w, idx, sp, lam, n, loss)
        torch.cuda.synchronize()
        ap, dwp = local_sdca_ref(Xs, ys, a, w, idx, sp, lam, n, loss)
        err_a = float((ak - ap).abs().max())
        err_dw = float((dwk - dwp).abs().max())
        scale_dw = float(dwp.abs().max())
        combine = (lambda dw: dw.sum(0)) if plus else (lambda dw: dw.mean(0))
        pk, pp = float(problem.primal(w + combine(dwk))), float(problem.primal(w + combine(dwp)))
        print(f"{name:28s} nl={nl} H={idx.shape[1]}: max|da|={err_a:.3e} "
              f"max|ddw|={err_dw:.3e} (max|dw|={scale_dw:.3e}) "
              f"primal {pk:.7f} vs {pp:.7f}")
        if not (torch.isfinite(ak).all() and torch.isfinite(dwk).all()):
            fail(f"{name}: kernel output is not finite")
        if m * nl > problem.n and not torch.equal(ak.reshape(-1)[problem.n:],
                                                   a.reshape(-1)[problem.n:]):
            fail(f"{name}: padded rows changed")
        if err_a > A_ATOL or err_dw > DW_RTOL_OF_MAX * scale_dw:
            fail(f"{name}: kernel disagrees with the plain version")
        if abs(pk - pp) > PRIMAL_RTOL * abs(pp):
            fail(f"{name}: primal after the call disagrees ({pk} vs {pp})")
        max_err = max(max_err, err_a, err_dw)
        if inputs_16 is None:
            inputs_16 = (Xs, ys, a, w, idx, sp, loss)
    print(f"tolerances: |da| <= {A_ATOL}, |ddw| <= {DW_RTOL_OF_MAX} max|dw|, "
          f"primal rtol {PRIMAL_RTOL}")

    phase("small-input check: CoCoA on the card vs the plain version on the CPU")
    X, y = synthetic_mnist(2048, 64, 16, 0.09, 0.35, 0)
    for plus in (False, True):
        cfg = CocoaConfig(4, 5, plus=plus)
        orders = [draw_indices(4, 512, 512, torch.Generator().manual_seed(r)) for r in range(5)]
        recs = [run_cocoa(problem_from_numpy(X, y, 1e-3, device=d), cfg,
                          indices=lambda it: orders[it]) for d in ("cuda", "cpu")]
        for key in ("primal", "dual"):
            got, want = getattr(recs[0], key), getattr(recs[1], key)
            if got.shape != (5,) or not abs(got - want).max() <= CURVE_RTOL * abs(want).max():
                fail(f"small-input {key} curve (plus={plus}): card {got} vs cpu {want}")
        print(f"plus={plus}: primal {recs[0].primal[-1]:.7f} (card) vs "
              f"{recs[1].primal[-1]:.7f} (cpu), gap {recs[0].gap[-1]:.3e}")

    phase("timings (m=16, CUDA events, after warm-up)")
    Xs, ys, a, w, idx, sp, loss = inputs_16
    m, nl, d = Xs.shape
    for _ in range(3):
        ops.local_sdca(Xs, ys, a, w, idx, sp, lam, n, loss)
    reps = 10
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        ops.local_sdca(Xs, ys, a, w, idx, sp, lam, n, loss)
    stop.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    local_sdca_ref(Xs, ys, a, w, idx, sp, lam, n, loss)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    nbytes, flops = sdca_bytes_and_flops(m, nl, d, idx)
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"local_sdca m={m} nl={nl} d={d} H={idx.shape[1]}: kernel {kernel_ms:.3f} ms/launch, "
          f"plain {plain_ms:.1f} ms/call, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e9:.3f} GFLOP at 67 TFLOP/s = "
          f"{ops_ms:.4f} ms), kernel at {100 * bound_ms / kernel_ms:.2f}% of bound; "
          "no single PyTorch call computes this")

    phase("main path: Hemingway loop, 60000 x 784, m = 1..128")
    ms = (1, 2, 4, 8, 16, 32, 64, 128)
    for name, ours, default in (("CoCoA rounds per m", SIM_ITERS, quickstart.SIM_ITERS),
                                ("P* rounds", REF_ITERS, quickstart.REF_ITERS)):
        if ours != default:
            print(f"cut: {name} {default} -> {ours} (n, d and m are not cut)")
    ops.local_sdca.launches = 0
    result = quickstart.run(ms=ms, iters=SIM_ITERS, ref_iters=REF_ITERS, device=dev)
    launches = ops.local_sdca.launches
    # P*, then per m a warm-up round, the timed rounds, and the dispatch
    # floor's warm-up and three timed rounds
    rounds = REF_ITERS + sum(1 + SIM_ITERS + 1 + 3 for _ in ms)
    print(f"local_sdca launches {launches}, CoCoA rounds run {rounds}")
    if launches != rounds:
        fail(f"launch count {launches} != rounds run {rounds}")
    for m in ms:
        t, r, g = result["t_iter"][m], result["round_s"][m], result["final_gap"][m]
        if not (t > 0 and r > 0 and abs(g) < float("inf")):
            fail(f"m={m}: t_iter={t}, round={r}, gap={g}")
    print(json.dumps({"main_path": {k: result[k] for k in
                                    ("p_star", "round_s", "t_iter", "final_gap", "f_m", "r2",
                                     "fastest_to_epsilon", "best_within_budget", "seconds")}}))

    phase("device busy share (torch.profiler over 5 CoCoA rounds with their recording)")
    from torch.profiler import ProfilerActivity, profile
    for m in (1, 16, 128):
        run_cocoa(problem, CocoaConfig(m, 1))  # warm-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rec = run_cocoa(problem, CocoaConfig(m, 5))
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        sdca_ms = sum(e.self_device_time_total for e in events if "sdca_kernel" in e.key) / 1e3
        print(f"m={m}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
              f"(share {busy_ms / wall_ms:.4f}), of it sdca_kernel {sdca_ms:.2f} ms; "
              f"timed rounds {rec.compute_seconds * 1e3:.2f} ms")
        if busy_ms <= 0:
            fail("the profiler saw no device time")

    print(json.dumps({"kernels": [{
        "name": "local_sdca",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sdca/csrc/sdca.cu",
        "replaces": "src/repro/kernels/sdca/kernel.py:68",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
