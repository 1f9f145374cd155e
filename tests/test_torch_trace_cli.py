"""Port parity: the serve CLI's router, migration and tracing flags and the
telemetry CLI (``python -m repro_torch.telemetry``) against the JAX
package's.

Identity surfaces:

* both serve CLIs, run as subprocesses with ``--smoke --router --replicas 2
  --migrate-at 3 --trace ... --trace-clock steps --router-log ...`` (the
  port's with ``--device cpu``), write byte-identical Perfetto files, and
  their router logs hold equal ``router`` and ``span`` events (every
  field; the rows' kinds in the same order; ``serve_step`` and
  ``ckpt_cost`` rows equal but for their wall-clock seconds), and print
  the same dispatch, handoff, bit-identity and span-count lines;
* both telemetry CLIs' ``trace`` on the same router log print the same
  tree, attribution (a tuner cache's paged-decode rows joined in) and flame
  text and write byte-identical ``--perfetto`` files; both ``summarize``
  print the same report, per-replica lines included, and with ``--strict``
  exit 1 on a corrupted row.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.telemetry.__main__ import main as ref_telemetry
from repro_torch.kernels.tune.cache import ConfigCache, cache_key
from repro_torch.telemetry.__main__ import main as port_telemetry

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-14b", "--smoke", "--router", "--replicas", "2", "--migrate-at", "3",
        "--trace-clock", "steps"]
PACKAGES = {"repro": [], "repro_torch": ["--device", "cpu"]}
WALL_FIELDS = {"serve_step": ("step_s", "t_s"), "ckpt_cost": ("wall_s",)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's serve CLI run once: its trace file, router log and
    standard output."""
    d = tmp_path_factory.mktemp("serve_cli")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = {}
    for pkg, extra in PACKAGES.items():
        trace, log = d / f"{pkg}.trace.json", d / f"{pkg}.router.jsonl"
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.launch.serve", *ARGS, *extra, "--trace", str(trace),
             "--router-log", str(log)],
            env=env, cwd=d, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        out[pkg] = (trace, log, proc.stdout)
    return out


def _rows(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]


def test_perfetto_files_byte_identical(runs):
    ref, port = runs["repro"][0].read_bytes(), runs["repro_torch"][0].read_bytes()
    assert port == ref
    payload = json.loads(port)
    assert sum(1 for r in payload["traceEvents"] if r["ph"] == "X") > 50
    names = {r["name"] for r in payload["traceEvents"] if r["ph"] == "X"}
    assert {"step", "prefill", "decode", "dispatch", "join"} <= names


def test_router_logs_hold_the_reference_events(runs):
    ref, port = _rows(runs["repro"][1]), _rows(runs["repro_torch"][1])
    assert [r["kind"] for r in port] == [r["kind"] for r in ref]
    assert {r["kind"] for r in port} == {"router", "span", "serve_step", "ckpt_cost"}
    for a, b in zip(port, ref):
        if a["kind"] in ("router", "span"):
            assert a == b
        else:
            drop = WALL_FIELDS[a["kind"]]
            assert ({k: v for k, v in a.items() if k not in drop}
                    == {k: v for k, v in b.items() if k not in drop})


def test_cli_lines_match_reference(runs):
    def lines(stdout):
        keep = []
        for line in stdout.splitlines():
            if line.startswith("migration:"):
                keep.append(line.rsplit(" in ", 1)[0])  # drop the handoff's ms
            elif line.startswith(("router:", "routed fleet", "trace:", "prefix reuse",
                                  "served ")) and "tok/s" not in line:
                keep.append(line.replace(str(runs["repro"][0]), "T")
                            .replace(str(runs["repro_torch"][0]), "T"))
        return keep

    got, want = lines(runs["repro_torch"][2]), lines(runs["repro"][2])
    assert got == want
    assert "routed fleet vs single engine: bit_identical=yes" in got
    assert any(line.startswith("migration: replica 0 handed off at step 3") for line in got)


def _tune_cache(path) -> str:
    """A tuner cache holding paged-decode rows at the smoke trace's batches."""
    cache = ConfigCache(str(path))
    for b, us in ((1, 41.5), (2, 47.25), (4, 60.0)):
        shape = {"b": b, "hk": 2, "g": 2, "d": 16, "page": 16, "npp": 6}
        cache.put(cache_key("flash_decode_paged", shape, "bfloat16", "cuda"),
                  family="flash_decode_paged", shape=shape, dtype="bfloat16",
                  config={"pages_per_program": 4}, us_per_call=us, swept=3, pruned=0,
                  backend="cuda")
    cache.save()
    return str(path)


def test_telemetry_trace_matches_reference(runs, tmp_path, capsys):
    log = str(runs["repro_torch"][1])
    cache = _tune_cache(tmp_path / "tune.json")
    outs = {}
    for pkg, main in (("ref", ref_telemetry), ("port", port_telemetry)):
        perfetto = tmp_path / f"{pkg}.json"
        assert main(["trace", log, "--perfetto", str(perfetto), "--flame", "--tune-cache", cache,
                     "--n-layers", "2"]) == 0
        outs[pkg] = (capsys.readouterr().out.replace(str(perfetto), "P"), perfetto.read_bytes())
    assert outs["port"] == outs["ref"]
    text = outs["port"][0]
    assert "kernel/flash_decode_paged@b1" in text and "kernel/flash_decode_paged@b2" in text
    assert "spans," in text and "component" in text
    assert outs["port"][1] == runs["repro_torch"][0].read_bytes()
    for main in (ref_telemetry, port_telemetry):  # a log without spans
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        assert main(["trace", str(empty)]) == 1
    capsys.readouterr()


def test_telemetry_summarize_matches_reference_and_strict_fails_on_a_bad_row(
        runs, tmp_path, capsys):
    log = runs["repro_torch"][1]
    bad = tmp_path / "bad.jsonl"
    rows = log.read_text().splitlines()
    bad.write_text("\n".join(rows[:5] + ['{"kind": "router", "step": 1}', "{not json"]
                             + rows[5:]) + "\n")
    outs = {}
    for pkg, main in (("ref", ref_telemetry), ("port", port_telemetry)):
        assert main(["summarize", str(log), "--strict"]) == 0
        good = capsys.readouterr().out
        assert main(["summarize", str(bad), "--strict"]) == 1
        assert main(["summarize", str(bad)]) == 0
        outs[pkg] = (good, capsys.readouterr())
    assert outs["port"][0] == outs["ref"][0]
    assert outs["port"][1].out == outs["ref"][1].out
    assert outs["port"][1].err.replace("repro_torch", "repro") == outs["ref"][1].err
    good = outs["port"][0]
    assert "per-replica:" in good and "replica 0:" in good and "replica 1:" in good
    assert "0 invalid rows" in good
    assert "2 invalid rows" in outs["port"][1].out
