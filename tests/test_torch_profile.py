"""``profile_step.py`` on the CPU.

The profiles themselves need a CUDA card (``python3 profile_step.py``).
Here: the op class of kernel names taken from the card's traces, ``summarize``
on a hand-written chrome trace, one step of every cell's workload at a small
size with the SpMM calls it makes all recorded, the host-bound rule on
hand-written summaries, the names ``host_top`` gives cProfile's functions,
the host attribution of the small ``LP`` cell, and the exits without a card
and on an unknown ``--cell``.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

import profile_step as P
from gnn_tail_generalization_tpu_torch.ops import _build
from gnn_tail_generalization_tpu_torch.ops import spmm_kernels as K

SMALL = dict(n_node=1500, n_feat=32, n_hidden=32, n_class=5, n_edge=6000)
# the node cells take the stand-in dataset's shapes; its edges follow from them
NODE_SMALL = {k: SMALL[k] for k in ("n_node", "n_feat", "n_hidden", "n_class")}
SPLIT_SMALL = dict(n_node=SMALL["n_node"], n_edge=SMALL["n_edge"], eval_pos=64,
                   num_neg_eval=5)
CELL_SMALL = {
    "bench": dict(steps=1, **SMALL),
    "sharded S=1": dict(steps=1, **SMALL),
    "link bench": dict(steps=1, batch_size=512, n_feat=SMALL["n_feat"], **SPLIT_SMALL),
    "link default": dict(steps=1, batch_size=512, **SPLIT_SMALL),
    **{name: dict(epochs=1, n_hidden=SMALL["n_hidden"], **SPLIT_SMALL)
       for name in ("DGI", "EGI", "VGAE", "DGI call")},
    # the bench graph's cells: its raw edges at the small size
    **{name: dict(epochs=1, n_hidden=SMALL["n_hidden"], n_node=SMALL["n_node"],
                  n_edge=SMALL["n_edge"]) for name in ("GIN masking", "GIN contextpred")},
    "struct pretrain": dict(n_hidden=SMALL["n_hidden"], n_node=SMALL["n_node"],
                            n_edge=SMALL["n_edge"]),
    **{name: dict(emb_d=16, n_node=SMALL["n_node"], n_edge=SMALL["n_edge"])
       for name in ("edge LP logit", "edge LP emb")},
}
# the cells this profiler runs beyond the trainer, student, link and DGI
# cells: every trick of chip_smoke.py's zoo and the other baselines' paths
NEW_PATHS = ("BatchNorm", "PairNorm", "Jumping", "DropEdge", "LADIES", "FastGCN-bf16",
             "EGI", "VGAE", "GIN masking", "GIN contextpred", "struct pretrain",
             "edge LP logit", "edge LP emb", "DGI call")
# above the dense-adjacency threshold (4,096 nodes): the graphs get CSRs and
# schedules, so the SpMMs go through the kernels' wrappers
PLANNED = dict(n_node=9000, n_feat=16, n_hidden=32, n_class=5, n_edge=40000)

# (kernel name, class): names from the card's chrome traces (NVIDIA H100
# 80GB HBM3, torch 2.11.0+cu128; `python3 profile_step.py`, the cell at the
# end of each line), cut to their first 300 characters where longer; the
# whole names fall in the same classes
KERNELS = [
    ('sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas',
     'gemm'),  # semlp_part2
    ('nvjet_tst_128x288_64x4_2x1_v_bz_coopA_TNT',
     'gemm'),  # link_bench
    ('void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)',
     'gemm'),  # link_default
    ('void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm_bf16_128x128_64x3_nt_align8>(cutlass_80_tensorop_s16816gemm_bf16_128x128_64x3_nt_align8::Params)',
     'gemm'),  # link_bench
    ('void gemv2N_kernel<int, int, float, float, float, float, 128, 1, 2, 4, 1, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float> >(cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<fl',
     'gemm'),  # DenseNoNorm_attention
    ('void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::{lambda(float)#1}, std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigned int>, TrivialOffsetCalculator<1, unsigned i',
     'cast/copy'),  # link_bench
    ('void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >(int, at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul>)',
     'cast/copy'),  # link_bench
    ('void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 2, 128, 1, 16, 4>(char*, at::native::(anonymous namespace)::CatArrInputTensorMetadata<at::native::(anonymous namespace)::OpaqueType<4u>, unsigned int, 128, 1>, at::',
     'cast/copy'),  # DenseNoNorm_attention
    ('void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)',
     'elementwise'),  # link_default
    ('void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::(anonymous namespace)::where_kernel_impl(at::TensorIterator&)::{lambda()#1}::operator()() const::{lambda()#11}::operator()() const::{lambda(bool, float, float)#1}>(at::TensorIteratorBase&, at::native::(anonymo',
     'elementwise'),  # link_default
    ('void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)',
     'elementwise'),  # link_default
    ('void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::arange_cuda_out(c10::Scalar const&, c10::Scalar const&, c10::Scalar const&, at::Tensor&)::{lambda()#1}::operator()() const::{lambda()#4}::operator()() const::{lambda(long)#1}>(int, at::native::arange_cuda_out(c10::Scalar cons',
     'elementwise'),  # link_bench
    ('void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float, at::native::func_wrapper_t<float, at',
     'reduction'),  # link_default
    ('void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false>(int, float, float const*, float const*, float const*, float*, float*, float*)',
     'reduction'),  # semlp_part2
    ('void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernelTemplate<float, float, 32u, 32u, 256u, false, false, false>(long, long, float const*, float const*, float const*, float const*, float*, float*)',
     'reduction'),  # semlp_part2
    ('void at::native::(anonymous namespace)::layer_norm_grad_input_kernel_vectorized<float, float, false>(float const*, float const*, float const*, float const*, float const*, float*, int)',
     'reduction'),  # semlp_part2
    ('void at::native::(anonymous namespace)::nll_loss_forward_reduce_cuda_kernel_2d<float, float, long>(float*, float*, float const*, long const*, float const*, bool, long, long, long, long)',
     'reduction'),  # semlp_part2
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::ArgMaxOps<float>, unsigned int, long, 4, 4> >(at::native::ReduceOp<float, at::native::ArgMaxOps<float>, unsigned int, long, 4, 4>)',
     'reduction'),  # auto
    ('void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<at::native::index_kernel_impl<at::native::OpaqueType<4> >(at::TensorIteratorBase&, c10::ArrayRef<long>, c10::ArrayRef<long>)::{lambda(char*, char const*, long)#1}>(at::TensorIteratorBase&, c10::ArrayRef<long>, c10::ArrayR',
     'index'),  # link_default
    ('void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long, long, long, bool)',
     'index'),  # DGI
    ('void (anonymous namespace)::indexing_backward_kernel<float, 4>(long const*, long const*, float const*, float*, long, long, long, long, bool)',
     'index'),  # link_default
    ('void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::_cuda_scatter_gather_internal_kernel<true, float, long>::operator()<at::native::ReduceAdd>(at::TensorIterator&, long, long, long, at::native::ReduceAdd const&)::{lambda(int)#1}>(int, at::native::_cuda_scatter_gather_internal_ker',
     'index'),  # bench
    ('void at::native::mbtopk::computeBlockDigitCounts<float, unsigned int, unsigned int, 2>(at::cuda::detail::TensorInfo<float const, unsigned int>, unsigned int, unsigned int*, unsigned int, unsigned int, int, int, unsigned int, unsigned int, unsigned int*, short*)',
     'sort/top-k'),  # semlp_part2
    ('void at::native::mbtopk::gatherTopK<float, unsigned int, 2>(at::cuda::detail::TensorInfo<float const, unsigned int>, unsigned int, unsigned int, bool, unsigned int, unsigned int, at::cuda::detail::TensorInfo<float, unsigned int>, unsigned int, at::cuda::detail::TensorInfo<long, unsigned int>, unsign',
     'sort/top-k'),  # semlp_part2
    ('void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::DeviceRadixSortPolicy<long, at::cuda::cub::detail::OpaqueType<8>, unsigned long long>::Policy900, false, long, at::cuda::cub::detail::OpaqueType<8>, unsigned long long, int, int, at_cuda_detail::cub::detail::identity_decomp',
     'sort/top-k'),  # link_default
    ('void at::native::bitonicSortKVInPlace<2, -1, 16, 16, float, long, at::native::GTOp<float, true>, unsigned int>(at::cuda::detail::TensorInfo<float, unsigned int>, unsigned int, unsigned int, unsigned int, at::cuda::detail::TensorInfo<long, unsigned int>, unsigned int, at::native::GTOp<float, true>)',
     'sort/top-k'),  # semlp_part2
    ('void compute_cuda_kernel<long>(long const*, long const*, long*, long, long)',
     'index'),  # DropEdge
    ('void at::native::roll_cuda_kernel<float>(float const*, float*, long, long, long, long, long, long)',
     'cast/copy'),  # GIN_contextpred
    ('at::native::(anonymous namespace)::fill_reverse_indices_kernel(long*, int, at::cuda::detail::IntDivider<unsigned int>)',
     'sort/top-k'),  # FastGCN_bf16
    ('void (anonymous namespace)::softmax_warp_forward<float, float, float, 6, true, false>(float*, float const*, int, int, int, bool const*, int, bool)',
     'softmax'),  # bench
    ('void (anonymous namespace)::softmax_warp_backward<float, float, float, 6, true, false>(float*, float const*, float const*, int, int, int, bool const*)',
     'softmax'),  # bench
    ('void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<float, 4, at::native::templates::cuda::uniform_and_transform<float, float, at::CUDAGeneratorImpl*, at::native::templates::cuda::uniform_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, double, at::CUDA',
     'rng'),  # link_default
    ('void (anonymous namespace)::randperm_handle_duplicate_keys_kernel<long, at::native::(anonymous namespace)::OpaqueType<8> >(long*, at::native::(anonymous namespace)::OpaqueType<8>*, long, int, at::PhiloxCudaState)',
     'rng'),  # DGI
    ('void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::TernaryOpScalarFunctor<float, 2, 2, 0>, at::native::LerpFunctor<float>, float>(at::native::(anonymous namespace)::TensorListMetadata<2>, at::',
     'optimizer'),  # link_default
    ('void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous namespace)::UnaryOpFunctor<float, 2, 1, 1>, at::native::Sqrt<float> >(at::native::(anonymous namespace)::TensorListMetadata<2>, at::native::(anonymous na',
     'optimizer'),  # link_default
    ('void (anonymous namespace)::spmm_light_kernel<__nv_bfloat16, 8, 1>(int const*, int const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float*, int, int, int, int)',
     'spmm'),  # link_bench
    ('void (anonymous namespace)::spmm_hub_chunk_kernel<float, 4, 2>(int const*, float const*, float const*, float*, int const*, int, int)',
     'spmm'),  # link_default
    ('(anonymous namespace)::spmm_hub_reduce_kernel(float const*, float*, int const*, int const*, int)',
     'spmm'),  # link_default
]
EVENTS = [("kernel", name, cls) for name, cls in KERNELS] + [
    ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", "copies"),
    ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", "copies"),
    ("gpu_memset", "Memset (Device)", "memset"),
    ("kernel", "a kernel no pattern names", "other"),
]


@pytest.mark.parametrize("cat,name,cls", EVENTS,
                         ids=[f"{i}-{cls}" for i, (_, _, cls) in enumerate(EVENTS)])
def test_op_class_of_the_card_trace_names(cat, name, cls):
    assert P.op_class(cat, name) == cls


def event(cat, name, ts, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_a_hand_written_trace(tmp_path):
    """Times in us. A copy before the first kernel counts in the device time
    but not in the loop; two kernels overlap; two gaps (350-400, 420-500)
    lie in the loop's span 200-750."""
    gemm = "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_stage3"
    elem = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>()"
    spmm = "void (anonymous namespace)::spmm_hub_chunk_kernel<float, 4, 2>(int)"
    events = [
        event("cpu_op", "aten::mm", 0, 1000),  # host events are not device time
        event("cuda_runtime", "cudaLaunchKernel", 190, 5),
        event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 100, 50),
        event("kernel", gemm, 200, 100),
        event("kernel", elem, 250, 100),
        event("gpu_memset", "Memset (Device)", 400, 20),
        event("kernel", spmm, 500, 200),
        event("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 650, 100),
        event("ac2g", "flow", 200, 0, ph="f"),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = P.summarize(str(path), steps=2)
    assert s["device_ms"] == pytest.approx(0.570)
    assert s["by_class_ms"] == pytest.approx(
        {"copies": 0.150, "gemm": 0.100, "elementwise": 0.100, "memset": 0.020,
         "spmm": 0.200})
    assert s["share"]["spmm"] == pytest.approx(0.200 / 0.570)
    assert s["loop_span_ms"] == pytest.approx(0.550)
    assert s["loop_busy_ms"] == pytest.approx(0.420)  # 200-350, 400-420, 500-750
    assert s["loop_busy_share"] == pytest.approx(0.420 / 0.550)
    assert s["loop_idle_share"] == pytest.approx(0.130 / 0.550)
    assert s["device_ms_per_step"] == pytest.approx(0.285)
    assert s["launches_per_step"] == pytest.approx(1.5)  # 3 kernels over 2 steps
    assert s["spmm_launches"] == {"spmm_hub_chunk_kernel": 1}


def run_recorded(window) -> tuple:
    """(step ms, output, recorded SpMM calls) of one run of ``window``; the
    launch counts are reset before it."""
    _build.reset_launch_counts()
    calls = []
    with P.recorded_spmm_calls(calls):
        step_ms, out = window.run()
    return step_ms, out, calls


@pytest.mark.parametrize("name", list(P.cells()))
def test_each_cell_runs_one_step_on_the_cpu(name):
    """The cell's workload built small on the CPU and its window run once
    (one epoch, train step or call): a finite loss or output, and every
    SpMM wrapper call recorded."""
    window = P.cells(epochs=1)[name](device="cpu", **CELL_SMALL.get(name, NODE_SMALL))
    step_ms, out, calls = run_recorded(window)
    assert window.steps == 1 and np.isfinite(step_ms) and P.finite(out)
    spmm = _build.launch_counts("spmm_csr")
    assert len(calls) == sum(spmm.values()) == spmm["spmm_csr_plain"]


@pytest.mark.parametrize("name", ["GroupNorm", "bench"])
def test_the_recorder_sees_every_spmm_of_a_window(name):
    """On graphs with CSRs every SpMM of the window goes through a wrapper:
    the recorded calls are the launch counts (the teacher's: two a layer in
    the train step, one in the eval forward), and their bound is the sum of
    ``spmm_bound`` over them."""
    size = (dict(steps=1, **PLANNED) if name == "bench"
            else {k: PLANNED[k] for k in NODE_SMALL})
    _, _, calls = run_recorded(P.cells(epochs=1)[name](device="cpu", **size))
    layers, per_layer = 2, 2 if name == "bench" else 3
    assert len(calls) == _build.LAUNCHES["spmm_csr_plain"] == per_layer * layers
    want = sum(K.spmm_bound(types.SimpleNamespace(
        indices=ix, n_node=ip.numel() - 1, n_edge=ix.numel()), d, bf16)[0]
        for ip, ix, d, bf16 in calls)
    assert P.spmm_bound_ms(calls) == pytest.approx(want, rel=1e-12)
    assert {bf16 for *_, bf16 in calls} == {name == "bench"}


def test_the_registry_holds_every_trick_and_every_path():
    from chip_smoke import TRICK_RUNS

    names = list(P.cells())
    assert set(TRICK_RUNS) <= set(names) and set(NEW_PATHS) <= set(names)
    assert len(names) == len(set(names)) == 30


@pytest.mark.parametrize("wall_ms,device_ms,bound", [
    (323.9637, 14.5276, True),    # a run_pure_lp call: host work around 50 propagations
    (20.0001, 10.0, True),
    (20.0, 10.0, False),          # exactly twice: not more than twice
    (95.0, 91.9053, False),       # a link bench step
    (5.0, 0.0, True),             # no device time at all
])
def test_host_bound_rule_on_hand_written_summaries(wall_ms, device_ms, bound):
    assert P.host_bound({"wall_ms": wall_ms, "device_ms": device_ms}) is bound


SITE = os.path.join(os.sep, "usr", "lib", "python3.12", "site-packages")


@pytest.mark.parametrize("file,line,name,label", [
    (os.path.join(SITE, "numpy", "lib", "_arraysetops_impl.py"), 138, "unique",
     "numpy/lib/_arraysetops_impl.py:138(unique)"),
    (os.path.join(SITE, "scipy", "sparse", "_base.py"), 560, "dot",
     "scipy/sparse/_base.py:560(dot)"),
    (os.path.join(os.sep, "src", "gnn_tail_generalization_tpu_torch", "propagation",
                  "cs.py"), 74, "pre_step",
     "gnn_tail_generalization_tpu_torch/propagation/cs.py:74(pre_step)"),
    ("~", 0, "<method 'argsort' of 'numpy.ndarray' objects>",
     "<method 'argsort' of 'numpy.ndarray' objects>"),
    ("~", 0, "<built-in method numpy.concatenate>", "<built-in method numpy.concatenate>"),
    ("~", 0, "<built-in method builtins.len>", None),
    ("~", 0, "<built-in method torch.cat>", None),
    (os.path.join(SITE, "torch", "nn", "modules", "module.py"), 1, "_call_impl", None),
    (os.path.join(os.sep, "src", "profile_step.py"), 1, "run", None),
], ids=["numpy", "scipy", "the port", "numpy method", "numpy builtin", "builtin", "torch C",
        "torch", "the profiler"])
def test_host_function_names_the_package_numpy_and_scipy(file, line, name, label):
    assert P.host_function(file, line, name) == label


def test_host_attribution_of_the_small_lp_cell():
    """The small ``LP`` cell's window under cProfile: at most ``HOST_TOP``
    functions, by cumulative seconds, among them the DAD adjacency's host
    build, every share in [0, 1]."""
    window = P.cells()["LP"](device="cpu", **NODE_SMALL)
    window.run()
    top, wall_ms = P.host_profile(window, torch.device("cpu"))
    assert 0 < len(top) <= P.HOST_TOP and wall_ms > 0
    assert [r["s"] for r in top] == sorted((r["s"] for r in top), reverse=True)
    assert all(0 <= r["share"] <= 1 for r in top), top
    assert any("(gen_normalized_adjs)" in r["function"] or "(build_graph)" in r["function"]
               for r in top), [r["function"] for r in top]
    assert any(r["function"].startswith("gnn_tail_generalization_tpu_torch/train/loops.py:")
               and r["function"].endswith("(run_pure_lp)") for r in top)


@pytest.mark.parametrize("argv", [["--cell", "GroupNorm"], ["--cell", "no such cell"]],
                         ids=["no card", "unknown cell"])
def test_main_exits_nonzero_without_a_card_or_on_an_unknown_cell(argv, capsys):
    try:
        rc = P.main(argv)
    except SystemExit as e:  # argparse refuses the choice
        rc = e.code
    assert rc not in (0, None)
    err = capsys.readouterr().err
    if argv[1] in P.cells():
        assert "no CUDA device" in err
    else:
        for name in P.cells():
            assert name in err
