"""The dry-run's counter (``repro_torch.dist.op_costs``, ``op_analysis``): the
counterparts of ``tests/test_hlo_costs.py``'s seven cases, each against an
exact hand count, on the "meta" device; the ring-model wire factors equal
the reference's; each hand-written kernel's record equals its tuner
family's roofline formula (``repro_torch.kernels.tune.roofline``); and a
smoke train step on a (2, 2) stand-in mesh counts the same FLOPs, bytes,
kernels and collectives on "meta" as on real CPU tensors.

The port has no while loop: layer stacks and scans run unrolled, so the
loop cases are Python loops and ``n_whiles`` stays 0.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import pytest
import torch

from repro.dist.hlo_costs import _WIRE_FACTOR as REF_WIRE_FACTOR
from repro_torch.configs.base import ShapeSpec
from repro_torch.dist import op_analysis, op_costs
from repro_torch.dist.op_costs import WIRE_FACTOR, analyze, top_contributors
from repro_torch.kernels.tune import roofline
from repro_torch.kernels.tune.sweep import SWEEP_SHAPES, measured_call
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_scaled_mesh

M, K, N = 64, 128, 96


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_plain_matmul_exact():
    c = analyze(lambda a, b: a @ b, _meta(M, K), _meta(K, N))
    assert c.flops == 2 * M * N * K
    assert c.n_whiles == 0


def test_n_layers_count_n_times_one():
    def layers(a, ws):
        for w in ws:  # the unrolled layer stack
            a = a @ w
        return a

    ws = [_meta(K, K) for _ in range(10)]
    assert analyze(layers, _meta(M, K), ws).flops == 10 * 2 * M * K * K


def test_nested_loops_multiply():
    def nested(a, ws):
        for w3 in ws:
            for w in w3:
                a = a @ w
        return a

    ws = [[_meta(K, K) for _ in range(4)] for _ in range(3)]
    assert analyze(nested, _meta(M, K), ws).flops == 12 * 2 * M * K * K


def test_loop_with_a_static_bound():
    def fori(a, w):
        for _ in range(7):
            a = a @ w
        return a

    assert analyze(fori, _meta(M, K), _meta(K, K)).flops == 7 * 2 * M * K * K


def test_grad_counts_forward_and_backward():
    a = _meta(M, K).requires_grad_()
    b = _meta(K, N).requires_grad_()

    def step(a, b):
        torch.sum((a @ b) ** 2).backward()

    # fwd (2MNK) + two bwd matmuls (dA = g b^T: 2MKN, dB = a^T g: 2KMN)
    assert analyze(step, a, b).flops == 3 * 2 * M * N * K


def test_bytes_and_collectives_nonnegative():
    c = analyze(lambda a, b: a @ b, _meta(M, K), _meta(K, N))
    assert c.bytes_accessed == 4 * (M * K + K * N + M * N)  # read a, b; write the product
    assert c.collective_wire_bytes == 0 == op_analysis.collective_wire_bytes(c)
    assert op_analysis.collective_breakdown(c) == {}


def test_top_contributors_finds_the_matmul():
    c = analyze(lambda a, b: torch.relu(a @ b), _meta(M, K), _meta(K, N))
    rows = top_contributors(c, "flops", 3)
    assert rows and rows[0][0] == 2 * M * N * K and "mm" in rows[0][1]
    with pytest.raises(ValueError):
        top_contributors(c, "time")


@pytest.mark.parametrize("kind", sorted(REF_WIRE_FACTOR))
def test_wire_factors_are_the_reference_s(kind):
    for n in range(1, 17):
        assert WIRE_FACTOR[kind](n) == REF_WIRE_FACTOR[kind](n)


KERNEL_FAMILIES = [("flash_attention", {"block_q": 16, "block_k": 16}, "flash_fwd"),
                   ("flash_decode", {"block_k": 32}, "flash_decode"),
                   ("flash_decode_paged", {"pages_per_program": 2}, "paged_decode"),
                   ("ssm_scan", {"d_block": 16}, "selective_scan"),
                   ("sdca", {"use_pallas": 1}, "local_sdca")]


@pytest.mark.parametrize("family, config, name", KERNEL_FAMILIES,
                         ids=[f for f, _, _ in KERNEL_FAMILIES])
def test_each_kernel_records_its_tuner_family_s_formula(family, config, name):
    """One call of the tuner's case on the CPU (the plain version runs): one
    record of the family's FLOPs and bytes, none of the plain version's
    operations.  The decode kernels count every position of the cache (the
    dry-run's program has no lengths to read), the tuner its ragged ones;
    K3 the pairs its causal mask leaves, the tuner the whole square."""
    shape = SWEEP_SHAPES["smoke"][family]
    fn, args = measured_call(family, shape, "float32", torch.device("cpu"), config)
    c = analyze(fn, *args)
    est = roofline.estimate(family, shape, config, "float32")
    flops = est.flops
    if family == "flash_attention":  # the tuner's case is causal, its estimate the square
        b, h, s, d = shape["b"], shape["h"], shape["s"], shape["d"]
        flops = roofline.flash_attention_cost(b, h, h, s, s, d, d, 4, causal=True)[0]
        assert flops == est.flops * roofline.causal_pairs(s, s) / (s * s)
    assert c.kernels == {name: {"launches": 1, "flops": int(flops),
                                "bytes": c.kernels[name]["bytes"]}}
    nbytes = est.bytes_moved
    if family == "flash_decode":
        nbytes = roofline.decode_cost(shape["b"], shape["h"], shape["h"], shape["s"],
                                      shape["d"], shape["b"] * shape["s"], 4)[1]
    if family == "flash_decode_paged":
        s = shape["npp"] * shape["page"]
        nbytes = roofline.decode_cost(shape["b"], shape["hk"] * shape["g"], shape["hk"], s,
                                      shape["d"], shape["b"] * s, 4)[1]
    assert c.kernels[name]["bytes"] == int(nbytes)
    assert c.flops == int(flops)  # the kernel's record, nothing of its plain version


def test_the_backward_kernels_record_their_bounds():
    """K3-bwd (a dq and a dk/dv pass) and K4-bwd (a scan pass and its
    reduction) from the functions PERF.md's bounds came from."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssm_scan.ops import default_bwd_d_block, selective_scan
    from repro_torch.kernels.ssm_scan.ref import bwd_cluster

    q, k, v = (torch.empty(2, 4, 64, 16, device="meta", requires_grad=True)
               for _ in range(3))
    c = analyze(lambda: flash_attention(q, k, v, causal=True).sum().backward())
    for name, pass_no in (("flash_bwd_dq", 0), ("flash_bwd_dkdv", 1)):
        f, b = roofline.flash_bwd_pass_cost(pass_no, 2, 4, 4, 64, 64, 16, 16, itemsize=4)
        assert c.kernels[name] == {"launches": 1, "flops": int(f), "bytes": int(b)}
    assert c.kernels["flash_fwd"]["launches"] == 1
    x = torch.empty(2, 64, 32, device="meta", requires_grad=True)
    dt = torch.empty(2, 64, 32, device="meta")
    A, D = torch.empty(32, 4, device="meta"), torch.empty(32, device="meta")
    B = C = torch.empty(2, 64, 4, device="meta")
    c = analyze(lambda: selective_scan(x, dt, A, B, C, D)[0].sum().backward())
    f, b = roofline.scan_bwd_cost(2, 64, 32, 4, 4)
    assert c.kernels["selective_scan_bwd"] == {"launches": 1, "flops": int(f), "bytes": int(b)}
    parts = bwd_cluster(32, default_bwd_d_block(4, 2, 64, 32))[1]
    f, b = roofline.scan_bwd_reduce_cost(2, 64, 32, 4, parts, 4)
    assert c.kernels["selective_scan_bwd_reduce"] == {"launches": 1, "flops": int(f),
                                                      "bytes": int(b)}


def test_a_smoke_train_step_counts_the_same_on_meta_as_on_the_cpu():
    """The rank (0, 0) of a (2, 2) stand-in mesh: stablelm's smoke config,
    16 positions x 8 rows (4 a rank of "data"), FSDP over "data", 2-way
    tensor parallelism, full remat; on "meta" and on real CPU tensors (the
    plain versions run, the collectives move nothing)."""
    shape = ShapeSpec("tiny_train", 16, 8, "train")
    counts = {}
    for device in ("meta", "cpu"):
        program, ctx = dryrun.lower_cell("stablelm-1.6b", shape, False, smoke=True,
                                         mesh=make_scaled_mesh(4, 2, device=device))
        counts[device] = op_costs.count(program.fn, arguments=program.arguments)[1]
    meta, cpu = counts["meta"], counts["cpu"]
    assert meta.flops == cpu.flops > 0
    assert meta.bytes_accessed == cpu.bytes_accessed > 0
    assert meta.kernels == cpu.kernels and meta.kernels["flash_fwd"]["launches"] == 2
    assert meta.rows == cpu.rows
    for key in ("collective_operand_bytes", "collective_wire_bytes", "per_kind_operand",
                "per_kind_wire", "per_axis_wire"):
        assert getattr(meta, key) == getattr(cpu, key), key
    assert set(meta.per_kind_operand) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert set(meta.per_axis_wire) == {"data", "model"}
