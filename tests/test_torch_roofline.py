"""The port's roofline (``roofline.py``) and cost registry (``costs.py``):
the classifier against the JAX package's on the same inputs, the Kineto
trace parser on a trace written here (device kernels on two streams, an
aten op's shapes, a kernel replayed from a CUDA Graph) and on a real
``torch.profiler`` trace of the CPU, and the kernels' analytic entries
against PERF.md's bound formulas."""

import json
import math
import os

import pytest
import torch

from distributedpytorch_tpu import roofline as jax_roofline
from distributedpytorch_tpu_torch import costs, roofline
from distributedpytorch_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("flops,nbytes,kind,dtype,name", [
    (1e9, 1e6, None, None, "fusion.3"),
    (1e6, 1e6, None, "bf16", "x"),
    (None, None, None, None, "convolution.4"),
    (None, 1e6, "cpu", "f32", "dot_general"),
    (None, None, None, None, "copy"),
    (5e9, 0.0, None, "bf16", "gemm_bf16"),
])
def test_bound_class_equals_jax(flops, nbytes, kind, dtype, name):
    assert roofline.bound_class(flops, nbytes, kind, dtype, name) == \
        jax_roofline.bound_class(flops, nbytes, kind, dtype, name)


def test_classify_equals_jax_on_the_same_inputs():
    parsed = {"ops": {("m", "dot.1"): {"time_us": 40.0, "count": 2},
                      ("m", "add.7"): {"time_us": 25.0, "count": 5},
                      ("n", "conv.2"): {"time_us": 10.0, "count": 1}},
              "step_time_us": 100.0, "attributed_us": 75.0,
              "residual_us": 25.0, "coverage": 0.75, "n_trace_files": 1,
              "n_events": 8, "warnings": ["w"]}
    for costs_data in (None, {"programs": {"train_step": {"flops": 1.0}}}):
        assert roofline.classify(parsed, None, costs_data) == \
            jax_roofline.classify(parsed, None, costs_data)


def test_kernel_symbols():
    assert roofline.kernel_symbol(
        "void flash_fwd_mma_kernel<__nv_bfloat16, 32, false>"
        "(__nv_bfloat16 const*, int)") == "flash_fwd_mma_kernel"
    assert roofline.kernel_symbol(
        "void flash_dq_mma_kernel<__half, 32, true>(x)") == \
        "flash_dq_mma_kernel:pos"
    assert roofline.kernel_symbol(
        "void conv_dw_mma_kernel<__nv_bfloat16, 64, 32>(x)") == \
        "conv_dw_mma_kernel"
    assert roofline.kernel_symbol("ampere_sgemm_64x64_nn") == \
        "ampere_sgemm_64x64_nn"
    # the port's kernels live in an anonymous namespace
    assert roofline.kernel_symbol(
        "void (anonymous namespace)::flash_dkv_mma_kernel<__nv_bfloat16, "
        "32, false>(__nv_bfloat16 const*, float*)") == "flash_dkv_mma_kernel"
    assert roofline.kernel_symbol(
        "void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<float>>(int)") == \
        "vectorized_elementwise_kernel"


# K1 at the vit's (64, 49, 4, 32) bf16: PERF.md's bound column reads q,
# k, v once, writes O and the f32 lse once; 2 products of 2 * D FLOPs a
# (q, k) pair and head
B, S, H, D = 64, 49, 4, 32


@pytest.mark.parametrize("kernel,products,tensors,row_vectors", [
    ("flash_fwd", 2, 4, 1), ("flash_dq", 3, 6, 2), ("flash_dkv", 4, 6, 2)])
def test_kernel_costs_follow_the_bound_formulas(kernel, products, tensors,
                                                row_vectors):
    flops, nbytes = costs.kernel_cost(kernel, (B, S, H, D))
    assert flops == products * 2 * B * H * S * S * D
    assert nbytes == tensors * B * S * H * D * 2 + row_vectors * B * H * S * 4


def test_kernel_costs_of_k5_and_the_ring():
    flops, nbytes = costs.kernel_cost("conv_dw", (64, 28, 28, 32),
                                      (64, 28, 28, 32))
    assert flops == 2 * 64 * 28 * 28 * 9 * 32 * 32
    assert nbytes == 64 * 28 * 28 * 64 * 2 + 9 * 32 * 32 * 4
    t, rows, pos = 128 * 25 * 4 * 32, 128 * 4 * 25 * 4, 2 * 25 * 4
    flops, nbytes = costs.kernel_cost("flash_fwd_pos", (128, 25, 4, 32))
    assert (flops, nbytes) == (2 * 2 * 128 * 4 * 25 * 25 * 32,
                               3 * t * 2 + pos + 4 * t + rows)


def test_wrappers_note_their_kernels_only_while_recording():
    costs.reset()
    q = torch.randn(2, 9, 2, 8)
    fa.flash_attention_fwd(q, q, q)
    assert costs.registry() == {}
    with costs.recording_kernels():
        fa.flash_attention_fwd(q, q, q)
        q4 = torch.randn(4, 9, 2, 8)
        fa.flash_attention_fwd(q4, q4, q4)                  # first wins
    reg = costs.registry()
    assert set(reg) == {"flash_fwd_mma_kernel", "flash_fwd_kernel"}
    entry = reg["flash_fwd_mma_kernel"]
    assert entry["source"] == "analytic_kernel"
    assert entry["shape"] == [2, 9, 2, 8] and entry["dtype"] == "f32"
    assert entry["flops"] == costs.kernel_cost(
        "flash_fwd", (2, 9, 2, 8), dtype=torch.float32)[0]
    costs.reset()


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur, "args": args}


K1 = ("void (anonymous namespace)::flash_fwd_mma_kernel<__nv_bfloat16, 32, "
      "false>(__nv_bfloat16 const*, int)")
GEMM = "void cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn"


def _kineto_trace(path, with_graph_kernel=True):
    """A Kineto trace of one step on a card: aten::mm launching a gemm on
    stream 7, K1 launched by the port's ctypes call (no aten op) on
    stream 7, an elementwise kernel on stream 20 overlapping it, and a
    kernel of a replayed CUDA Graph."""
    mm = _x("cpu_op", "aten::mm", 0, 50, **{
        "External id": 11, "Input Dims": [[64, 128], [128, 32]],
        "Input type": ["c10::BFloat16", "c10::BFloat16"]})
    events = [
        mm,
        _x("cuda_runtime", "cudaLaunchKernel", 10, 5, correlation=100,
           **{"External id": 11}),
        _x("kernel", GEMM, 100, 20, correlation=100,
           **{"External id": 11}),
        _x("cuda_runtime", "cuLaunchKernel", 60, 5, correlation=101),
        _x("kernel", K1, 130, 10, correlation=101),
        _x("kernel", "void elementwise_kernel<4>(x)", 135, 10,
           correlation=102),
        _x("cuda_runtime", "cudaGraphLaunch", 70, 5, correlation=103),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 90, 4,
           correlation=104),
    ]
    if with_graph_kernel:
        events.append(_x("kernel", K1, 200, 10, correlation=103))
    for ev in events:
        if ev["cat"] in ("kernel", "gpu_memcpy"):
            ev["pid"], ev["tid"] = 0, 20 if "elementwise" in ev["name"] \
                else 7
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_parse_a_kineto_trace_of_the_card(tmp_path):
    _kineto_trace(tmp_path / "rank0.trace.json")
    parsed = roofline.parse_trace_dir(str(tmp_path))
    ops = parsed["ops"]
    k1 = ops[("gpu", "flash_fwd_mma_kernel<__nv_bfloat16, 32, false>")]
    assert (k1["time_us"], k1["count"], k1["n_costed"]) == (20.0, 2, 0)
    gemm = ops[("gpu", GEMM[5:])]
    assert gemm["flops_total"] == 2 * 64 * 128 * 32
    assert gemm["bytes_total"] == (64 * 128 + 128 * 32 + 64 * 32) * 2
    assert gemm["dtype"] == "bf16" and gemm["launched_by"] == "aten::mm"
    # the step: the union of [90, 94), [100, 120), [130, 145), [200, 210)
    assert parsed["step_time_us"] == 4 + 20 + 15 + 10
    assert parsed["coverage"] == 1.0
    assert any("replayed from CUDA Graphs" in w for w in parsed["warnings"])
    k1_cost = costs.kernel_cost("flash_fwd", (B, S, H, D))
    data = {"device_kind": "NVIDIA H100 80GB HBM3", "programs": {
        "flash_fwd_mma_kernel": {"source": "analytic_kernel",
                                 "kernel": "flash_fwd", "dtype": "bf16",
                                 "flops": k1_cost[0],
                                 "bytes_accessed": k1_cost[1]}}}
    rep = roofline.classify(parsed, data["device_kind"], data)
    rows = {r["opcode"]: r for r in rep["ops"]}
    row = rows["flash_fwd"]
    assert row["class_source"] == "analytic" and row["bound"] == "memory"
    assert row["ridge_source"] == "device"
    assert math.isclose(row["ridge_flops_per_byte"], 989.4e12 / 3.35e12)
    assert math.isclose(row["arithmetic_intensity"],
                        k1_cost[0] / k1_cost[1])
    assert rows["aten::mm"]["class_source"] == "analytic"
    assert rep["ops"][0]["time_share"] == 20 / 49


def test_graph_kernels_missing_from_the_trace_are_reported(tmp_path):
    _kineto_trace(tmp_path / "a.trace.json", with_graph_kernel=False)
    parsed = roofline.parse_trace_dir(str(tmp_path))
    assert any("did not record the replayed graphs' kernels" in w
               for w in parsed["warnings"])


def test_parse_a_real_cpu_profile(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    a, b = torch.randn(64, 128), torch.randn(128, 32)
    x, w = torch.randn(2, 3, 16, 16), torch.randn(8, 3, 3, 3)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with record_function("train_step"):
            a @ b
            torch.nn.functional.conv2d(x, w, padding=1)
    prof.export_chrome_trace(str(tmp_path / "rank0.trace.json"))
    parsed = roofline.parse_trace_dir(str(tmp_path))
    mm = parsed["ops"][("cpu", "aten::mm")]
    assert mm["count"] == 1 and mm["flops_total"] == 2 * 64 * 128 * 32
    convs = [v for (m, n), v in parsed["ops"].items()
             if n in roofline._CONVS]
    assert [c["flops_total"] for c in convs] == [2 * 2 * 8 * 16 * 16 * 27]
    assert 0.0 < parsed["coverage"] <= 1.0
    assert parsed["step_time_us"] >= parsed["attributed_us"]
    rep = roofline.analyze(str(tmp_path))
    assert rep["ops"][0]["name"] in ("aten::mm", "aten::mkldnn_convolution",
                                     "aten::_slow_conv2d_forward")
    assert "roofline attribution" in roofline.render_report(rep)
    path = roofline.save_report(rep, str(tmp_path))
    assert json.load(open(path))["n_ops"] == rep["n_ops"]


def test_costs_json_schema_and_provenance(tmp_path):
    costs.reset("NVIDIA H100 80GB HBM3")
    costs.record("train_step", flops=123.0)
    costs.record_analytic("train_flops_per_sample", flops_per_sample=2.0)
    costs.record_mfu_denominator(989.4e12, "bf16", "NVIDIA H100 80GB HBM3")
    costs.record_kernel("flash_dq", (B, S, H, D))
    path = costs.save(str(tmp_path))
    doc = costs.load(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "costs.json")
    assert doc["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert set(doc["programs"]) == {
        "train_step", "train_flops_per_sample", "mfu_denominator",
        "flash_dq_mma_kernel", "flash_dq_kernel"}
    for entry in doc["programs"].values():
        assert {"ts", "mono", "device_kind", "torch_version",
                "source"} <= set(entry)
    assert doc["programs"]["mfu_denominator"]["peak_dtype"] == "bf16"
    costs.reset()
    assert costs.save(str(tmp_path / "empty")) is None
