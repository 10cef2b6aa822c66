"""CPU tests of the trace's reduction on a hand-built event list: device
time by class of operation, the classes against the busy time, the
per-step readers of two classes, and a CUDA graph's copy nodes kept out of
the program's own kernels."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import harness, trace  # noqa: E402

# (category, name, start µs, duration µs): one stream, no overlaps
OPS = [
    ("kernel", "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3_warpsize2x2x1", 10, 40),
    ("kernel", "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(Params)", 50, 30),
    ("kernel", "nvjet_tst_8x64_64x16_4x1_v_bz_bias_TNN", 80, 5),
    ("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float>>", 85, 3),
    ("kernel", "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", 88, 4),
    ("kernel", "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<FusedAdamMathFunctor>", 92, 6),
    ("kernel", "void at::native::(anonymous namespace)::distribution_elementwise_grid_stride_kernel<float>", 98, 2),
    ("kernel", "void (anonymous namespace)::su4_vjp_kernel<4, false, 1>(float const*)", 100, 20),
    ("kernel", "memcpy128", 120, 1),
    ("kernel", "memcpy32_post", 121, 1),
    ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 122, 2),
    ("gpu_memset", "Memset (Device)", 124, 1),
    ("kernel", "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float>", 125, 3),
    ("kernel", "void (anonymous namespace)::softmax_warp_forward<float>", 128, 2),
]
WANT_US = {"gemm": 75, "elementwise": 13, "draws": 2, "program": 20, "copy": 5, "other": 5}


def _events(ops=OPS, window=(0, 200), units=2):
    events = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
               "ts": window[0], "dur": window[1] - window[0]}]
    events += [{"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
               for cat, name, ts, dur in ops]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5})
    return trace.reduce(events, units)


def test_device_time_by_class():
    got = _events()
    assert got["by_class"] == pytest.approx({k: v * 1e-6 for k, v in WANT_US.items()})
    assert sum(got["by_class"].values()) == pytest.approx(got["busy_s"])


def test_overlapping_operations_sum_past_the_busy_time():
    got = _events(OPS + [("kernel", "void at::native::elementwise_kernel<128, 2>", 10, 40)])
    assert got["by_class"]["elementwise"] == pytest.approx(53e-6)
    assert sum(got["by_class"].values()) > got["busy_s"]
    assert got["busy_s"] == pytest.approx(sum(WANT_US.values()) * 1e-6)


def test_classes_are_clipped_to_the_window():
    got = _events(window=(60, 200))
    assert got["by_class"]["gemm"] == pytest.approx(25e-6)     # 20 of the sgemm, the nvjet 5


def test_graph_copy_nodes_are_not_program_kernels():
    got = _events()
    assert got["port_kernel_s"] == pytest.approx(20e-6) == got["by_class"]["program"]
    assert got["port_kernels"] == ["void (anonymous namespace)::su4_vjp_kernel<4, false, 1>(float"
                                   " const*)"[:80]]
    assert trace.is_library_kernel("memcpy128") and trace.is_library_kernel("memset32")


@pytest.mark.parametrize("name,cls", [("gemm_ms.step", "gemm"), ("elementwise_ms.step", "elementwise")])
def test_step_readers_of_device_time(name, cls):
    read = harness.load_module(REPO / "port_bench" / "metrics" / f"{name}.py",
                               f"port_bench.metrics.{name}").read
    tr = _events(units=2)
    assert read({"unit": "step", "trace": tr}) == pytest.approx(1e3 * WANT_US[cls] * 1e-6 / 2)
    assert read({"unit": "request", "trace": tr}) is None               # another kind of unit
    assert read({"unit": "step", "trace": None}) is None
    empty = _events(ops=[("kernel", "void (anonymous namespace)::mean_fid_kernel<2>", 10, 5)])
    assert read({"unit": "step", "trace": empty}) is None               # none of that class
