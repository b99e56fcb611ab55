"""The yardstick on the CPU: the op classes of the card's kernel names, the
trace summary and the per-layer readers on a hand-written trace, the frozen
byte rule and FLOP counts against hand counts and against the port's own
``spmm_bound``, and ``BENCHMARK.json`` against the contract's shape."""
import json
import re

import numpy as np
import pytest
import torch

import run
from harness import readers, roofline, spec, trace

# names as the card's traces give them
KERNELS = [
    ("void (anonymous namespace)::spmm_light_kernel<float, 4, 2>(int const*)", "spmm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(x)", "gemm"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", "gemm"),
    ("nvjet_sm90_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", "elementwise"),
    ("void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>", "cast/copy"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel", "rng"),
    ("void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>", "sort/top-k"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reduction"),
    ("void at::native::index_elementwise_kernel<128, 4>", "index"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<Adam>", "optimizer"),
    ("mystery_kernel", "other"),
]


@pytest.mark.parametrize("name,cls", KERNELS)
def test_op_class_of_card_kernel_names(name, cls):
    assert trace.op_class("kernel", name) == cls


def test_op_class_of_copies_and_memsets():
    assert trace.op_class("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)") == "copies"
    assert trace.op_class("gpu_memset", "Memset (Device)") == "memset"


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# a window of 2 steps: device events in us, with host spans and ops beside
EVENTS = [
    _ev("kernel", "spmm_light_kernel<float>", 100, 50),
    _ev("kernel", "cutlass_80_simt_sgemm", 140, 40),  # overlaps the first
    _ev("kernel", "vectorized_elementwise_kernel<add>", 200, 20),
    _ev("gpu_memcpy", "Memcpy HtoD", 300, 100),
    _ev("kernel", "vectorized_elementwise_kernel<add>", 450, 50),
    _ev("user_annotation", "window.unit", 0, 600),
    _ev("user_annotation", "setup.prep", -500, 100),
    _ev("cpu_op", "aten::to", 180, 30),
    _ev("cpu_op", "aten::_to_copy", 185, 20),  # inside aten::to
    _ev("cpu_op", "aten::item", 400, 40),
]


def test_summary_of_a_hand_written_trace():
    s = trace.summarize_events(EVENTS, steps=2, window_s=0.0006)
    assert s.kernels == 4
    assert s.class_s == pytest.approx({"spmm": 50e-6, "gemm": 40e-6, "elementwise": 70e-6,
                                       "copies": 100e-6})
    # busy: [100, 180) + [200, 220) + [300, 400) + [450, 500)
    assert s.busy_s == pytest.approx(250e-6)
    assert s.span_s == pytest.approx(400e-6)
    # gaps: 180-200 (host in aten::to), 220-300 (python), 400-450 (aten::item)
    assert dict(s.idle_gaps) == pytest.approx({"window.unit | aten::to": 20e-6,
                                               "window.unit | python": 80e-6,
                                               "window.unit | aten::item": 50e-6})
    assert s.device_ops[0] == ("Memcpy HtoD", pytest.approx(100e-6))


def test_gaps_are_labelled_by_the_harness_spans_alone():
    """The spans that label a gap are the harness's and the program's
    (``gnn.``): the innermost open one, however many closed before it
    inside the outer one. Torch's own spans, however many, neither label a
    gap nor hide the span around them."""
    inner = [_ev("user_annotation", "Optimizer.step#Adam.step", 10 + i * 0.1, 0.05)
             for i in range(300)]
    closed = [_ev("user_annotation", "gnn.replace", 40 + i * 0.1, 0.05) for i in range(300)]
    read = [_ev("user_annotation", "gnn.teacher.read", 390, 60)]
    s = trace.summarize_events(EVENTS + inner + closed + read, steps=2, window_s=0.0006)
    assert dict(s.idle_gaps) == pytest.approx({"window.unit | aten::to": 20e-6,
                                               "window.unit | python": 80e-6,
                                               "gnn.teacher.read | aten::item": 50e-6})


def test_readers_on_the_hand_written_trace():
    s = trace.summarize_events(EVENTS, steps=2, window_s=0.0006)
    work = {"flops": 67e12 * 0.0003 * 0.5, "spmm_least_s": 5e-6}
    r = run.Readings(s, work, {"prep": 1.5})
    assert readers.launches(r) == 2.0
    assert readers.class_ms(r, ("gemm",)) == pytest.approx(0.02)
    assert readers.class_ms(r, readers.PASSES) == pytest.approx(0.035)
    assert readers.idle_share(r) == pytest.approx(37.5)
    assert readers.mfu(r) == pytest.approx(50.0)
    assert readers.spmm_roofline(r) == pytest.approx(20.0)
    assert spec.load_module("metrics", "prep_s").read(r) == 1.5


#: each metric file's reading of ``EVENTS`` with the work of
#: ``test_readers_on_the_hand_written_trace``, as the readers gave it before
#: the summary kept every kernel's time
BEFORE = {"launches.epoch": 2.0, "dense_ms.epoch": 0.02, "passes_ms.epoch": 0.035,
          "topk_ms.epoch": 0.0, "spmm_roofline.epoch": 20.0, "idle_share.epoch": 37.5,
          "mfu.epoch": 50.0, "prep_s": 1.5}


def test_metric_files_read_the_hand_written_trace_as_before():
    s = trace.summarize_events(EVENTS, steps=2, window_s=0.0006)
    r = run.Readings(s, {"flops": 67e12 * 0.0003 * 0.5, "spmm_least_s": 5e-6}, {"prep": 1.5})
    got = {name: spec.load_module("metrics", name).read(r) for name in BEFORE}
    assert got == pytest.approx(BEFORE)


# 12 distinct kernels: one that no class matches, and one whose time ranks
# it below the top 10 of ``device_ops``
MANY = ([_ev("kernel", f"vectorized_elementwise_kernel<op{i}>", 1000 * i, 100 + i)
         for i in range(10)]
        + [_ev("kernel", "void graph_attention_fwd<float, 64>(int)", 20000, 300),
           _ev("kernel", "void graph_attention_fwd<float, 64>(int)", 21000, 100),
           _ev("kernel", "void small_kernel<1>(float*)", 22000, 5),
           _ev("gpu_memcpy", "Memcpy DtoD", 23000, 50)])


def test_summary_keeps_every_kernels_device_time():
    s = trace.summarize_events(MANY, steps=2, window_s=0.03)
    assert len(s.kernel_s) == 12 and "Memcpy DtoD" not in s.kernel_s
    assert s.kernel_s["void graph_attention_fwd<float, 64>(int)"] == pytest.approx(400e-6)
    assert s.kernel_s["void small_kernel<1>(float*)"] == pytest.approx(5e-6)
    assert "void small_kernel<1>(float*)" not in dict(s.device_ops)
    assert trace.op_class("kernel", "void graph_attention_fwd<float, 64>(int)") == "other"
    assert sum(s.kernel_s.values()) == pytest.approx(
        sum(v for k, v in s.class_s.items() if k != "copies"))


def test_kernel_readers_on_a_hand_written_trace():
    s = trace.summarize_events(MANY, steps=2, window_s=0.03)
    r = run.Readings(s, {"attn_least_s": 50e-6}, {})
    assert readers.kernel_ms(r, r"graph_attention_fwd") == pytest.approx(0.2)
    assert readers.kernel_ms(r, r"\bsmall_kernel<") == pytest.approx(0.0025)
    assert readers.kernel_ms(r, r"elementwise_kernel<op[0-1]>") == pytest.approx(0.1005)
    assert readers.kernel_roofline(r, r"graph_attention_fwd", "attn_least_s") == (
        pytest.approx(25.0))
    assert readers.kernel_ms(r, r"no_such_kernel") is None
    assert readers.kernel_roofline(r, r"no_such_kernel", "attn_least_s") is None
    assert readers.kernel_roofline(r, r"small_kernel", "no_such_work") is None
    assert readers.kernel_ms(run.Readings(None, {}, {}), r"small_kernel") is None


def test_readers_without_a_trace_find_nothing():
    r = run.Readings(None, {"flops": 1.0, "spmm_least_s": 1.0}, {})
    for name in ("launches.epoch", "dense_ms.link_step", "passes_ms.link_step", "topk_ms.epoch",
                 "spmm_roofline.epoch", "idle_share.epoch", "mfu.link_step"):
        assert spec.load_module("metrics", name).read(r) is None
    s = trace.summarize_events(EVENTS[2:3], steps=1, window_s=1.0)  # no SpMM kernel ran
    assert readers.spmm_roofline(run.Readings(s, {"spmm_least_s": 1.0}, {})) is None


def test_a_metric_family_has_one_reader():
    """``<family>.<suffix>`` without a file of its own is read by
    ``<family>.py``; a family without one is unknown."""
    assert (spec.load_module("metrics", "dense_ms.link_step")
            is spec.load_module("metrics", "dense_ms.epoch")
            is spec.load_module("metrics", "dense_ms.call"))
    with pytest.raises(spec.UnknownName):
        spec.load_module("metrics", "no_such_family.epoch")
    with pytest.raises(spec.UnknownName):
        spec.load_module("entries", "coldbrew_teacher.x")


@pytest.mark.parametrize("tf32", [True, False])
def test_precision_follows_the_configuration(tf32):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        run.apply_precision({"precision": {"tf32": tf32}})
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_byte_rule_and_flops_by_hand():
    # 3 rows, 2 distinct sources, 4 edges, d = 2: x 2*2*4 + y 3*2*4 + edges
    # 4*(4 + 4) + row pointers 4*4
    assert roofline.spmm_bytes(3, 2, 4, 2) == 88
    assert roofline.spmm_flops(4, 2) == 16
    assert roofline.gemm_flops(2, 3, 4) == 48
    big = roofline.spmm_least_s(10**6, 10**6, 10**7, 256)
    assert big == pytest.approx(roofline.spmm_bytes(10**6, 10**6, 10**7, 256) / 3.35e12)


def test_byte_rule_equals_the_ports_spmm_bound():
    """The frozen copy gives what the port's ``spmm_bound`` gives."""
    from gnn_tail_generalization_tpu_torch.graph.core import build_graph
    from gnn_tail_generalization_tpu_torch.ops.spmm_kernels import spmm_bound

    rng = np.random.default_rng(0)
    e = rng.integers(0, 500, (2, 4000))
    g = build_graph(e, 500, with_dense=False)
    n_src = int(torch.unique(g.indices).numel())
    for d in (1, 40, 256):
        assert roofline.spmm_least_s(500, n_src, 4000, d) * 1e3 == pytest.approx(
            spmm_bound(g, d, False)[0])


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contracts_shape():
    b = spec.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1] == "benchmark/run.py"
    assert len(json.dumps(b)) < 64 * 1024
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and NAME.match(c["name"])
        assert spec.config(b, c["name"])["name"] == c["name"]
        spec.load_module("reference", c["name"])
    cells = {w["name"]: w for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        spec.load_module("entries", spec.traffic(w["traffic"])["entry"])
    assert {w["config"] for w in b["workloads"]} == configs
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        spec.load_module("metrics", m["name"])
        for cell in m["workloads"]:
            moves = e2e[m["moves"]]
            assert "workloads" not in moves or cell in moves["workloads"], (m["name"], cell)
            assert cell in cells
    for name, w in cells.items():
        reported = [m["name"] for m in spec.end_to_end_for(b, w)]
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.per_layer_for(b, w, reported)
