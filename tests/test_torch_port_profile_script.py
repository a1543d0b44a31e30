"""``scripts/torch_profile_train_step.py``, the port's counterpart of
``scripts/profile_train_step.py``, on the CPU: its categories on kernel names
as the card's profiler reports them, its output keys and file names against
the JAX script's (read from that script's source, which imports JAX only
inside its functions), and one capture of a tiny finetune step under
``torch.profiler``. On the card ``chip_smoke.py`` phase 58 runs it at the
default geometry."""

from __future__ import annotations

import ast
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The tensors here are small, and the suite runs one worker a core: more
    than one intra-op thread a worker only contends for the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


tp = _load("torch_profile_train_step")

# kernel names as torch.profiler reports them on an H100 (the port's own
# kernels as csrc/ declares them), each with its category
CARD_NAMES = {
    "void causal_conv1d_silu_fwd_kernel<__nv_bfloat16, 4, 8>(ConvArgs<__nv_bfloat16>)":
        "conv_kernels",
    "void conv_any_dx<float>(AnyConv<float>)": "conv_kernels",
    "void selective_scan_fwd_kernel<__nv_bfloat16, true, false>(ScanArgs<__nv_bfloat16>)":
        "scan_kernels",
    "void selective_scan_bwd_kernel<__nv_bfloat16>(BwdArgs<__nv_bfloat16>)": "scan_kernels",
    "void (anonymous namespace)::scan_fwd<false, false>((anonymous namespace)::Fwd)":
        "scan_kernels",
    "void (anonymous namespace)::scan_fwd<true, false>((anonymous namespace)::Fwd)":
        "scan_kernels",
    "(anonymous namespace)::scan_bwd((anonymous namespace)::Bwd)": "scan_kernels",
    "void (anonymous namespace)::fwd_y<float, true, false, false>((anonymous namespace)::"
    "Args<float>)": "ssd_kernels",
    "void (anonymous namespace)::bwd_dbc<__nv_bfloat16, false, true>((anonymous namespace)::"
    "Args<__nv_bfloat16>)": "ssd_kernels",
    "void fused_mixer_bwd_kernel<float, 1>(FusedArgs<float>)": "fused_mixer_kernels",
    "void (anonymous namespace)::gemm_f32(float const*, float const*, float*, int, int, int)":
        "fused_mixer_kernels",
    "sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize128x128x32_warpgroupsize1x1x1_execute_"
    "segment_k_off_kernel__5x_cublas": "matmul",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_"
    "segment_k_off_kernel__5x_cublas": "matmul",
    "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTN": "matmul",
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_32x6_nn_align4>(Params)": "matmul",
    "void syevj_parallel_order_set_kernel<float>(int, int*)": "eigh_qr",
    "void geqrf_kernel<float>(int, int, float*)": "eigh_qr",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<Policy, false, float, int>(...)":
        "sort_topk",
    "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>(...)": "sort_topk",
    "Memcpy HtoD (Pageable -> Device)": "copy",
    "Memset (Device)": "copy",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<float, long, unsigned int, 2,"
    " 2, -2, true>(...)": "copy",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)":
        "elementwise_reduce",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, MeanOps>>(...)":
        "elementwise_reduce",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<FusedAdamMathFunctor>()":
        "elementwise_reduce",
}


@pytest.mark.parametrize("name", sorted(CARD_NAMES))
def test_categories_on_the_cards_kernel_names(name):
    assert tp.categorize(name) == CARD_NAMES[name]


def _jax_output_keys() -> list[str]:
    """The keys of the ``out`` dict that scripts/profile_train_step.py
    writes, from its source."""
    tree = ast.parse((ROOT / "scripts" / "profile_train_step.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no out = {...} in scripts/profile_train_step.py")


@pytest.mark.parametrize("flags,name", [
    ((), "profile_train_step.json"), (("--ssd",), "profile_ssd_step.json"),
    (("--ssd-fused",), "profile_ssd_fused_step.json"),
    (("--hardest",), "profile_hardest_step.json"),
    (("--hardest", "--ssd-fused"), "profile_hardest_ssd_fused_step.json"),
    (("--pretrain",), "profile_pretrain_step.json"),
    (("--pretrain", "--ssd"), "profile_pretrain_ssd_step.json")])
def test_file_names_are_the_jax_scripts(flags, name):
    assert tp.file_name("--pretrain" in flags, "--ssd" in flags, "--ssd-fused" in flags,
                        "--hardest" in flags) == name


def test_capture_on_the_cpu_writes_the_jax_scripts_keys(tmp_path, monkeypatch):
    """A tiny finetune step (2 blocks of width 32, 8 groups, B=2), profiled
    over two steps on the CPU: every key of the JAX script's JSON and only
    those, finite times, each op's calls a step, and the file under --out."""
    monkeypatch.setattr(tp, "K_STEPS", 2)
    tiny = dict(trans_dim=32, encoder_dims=32, depth=2, num_group=8, group_size=8, knn_graph=4,
                batch=2, points=128)
    wall, steps, events = tp.capture("cpu", over=tiny, trace_dir=str(tmp_path / "traces"))
    assert steps == 2 and wall > 0 and events
    out = tp.summarize(wall, steps, events, on_card=False)
    assert list(out) == _jax_output_keys()
    assert out["leaf_device_ms_per_step"] > 0 and out["control_flow_wrapper_ms_per_step"] == 0
    assert abs(sum(out["categories_ms"].values()) - out["leaf_device_ms_per_step"]) < 1e-2
    top = out["top_ops_ms"][0]
    assert set(top) == {"op", "ms", "calls"} and top["calls"] > 0
    assert set(out["top_ops_by_category"]) == set(out["categories_ms"])
    assert list((tmp_path / "traces").glob("trace_*.json"))
    json.dumps(out)


def test_refuses_to_write_under_benchmarks():
    with pytest.raises(SystemExit, match="not under benchmarks"):
        tp.main(["--device", "cpu", "--out", str(ROOT / "benchmarks" / "profiles")])
