"""The trace reduction on a hand-made Chrome trace: layers by the host
ranges open at each launch, the busy union, idle gaps and top operations."""

from gnnbench import traceparse


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _trace():
    ev = [
        # Forward on the main thread: a dense product, then the SpMM span.
        _x("cpu_op", "aten::mm", 0, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _x("user_annotation", traceparse.SPMM_SPAN, 20, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 1, correlation=2),
        _x("cpu_op", "aten::add", 40, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=3),
        # Backward on the autograd thread.
        _x("cpu_op", "autograd::engine::evaluate_function: _SpmmSumBackward",
           50, 10, tid=2),
        _x("cuda_driver", "cuLaunchKernel", 52, 1, tid=2, correlation=4),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 70,
           10, tid=2),
        _x("cpu_op", "aten::mm", 71, 8, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 72, 1, tid=2, correlation=5),
        # Device: kernels under a new name each.
        _x("kernel", "gemm_a", 5, 10, tid=7, correlation=1),
        _x("kernel", "walker_v9", 25, 20, tid=7, correlation=2),
        _x("kernel", "add", 44, 2, tid=7, correlation=3),
        _x("kernel", "walker_v9", 60, 20, tid=7, correlation=4),
        _x("gpu_memcpy", "Memcpy DtoD", 100, 4, tid=7, correlation=5),
    ]
    return {"traceEvents": ev + [{"ph": "M", "name": "process_name"}]}


def test_layers_by_the_open_ranges():
    s = traceparse.analyze(_trace(), steps=2)
    assert s["steps"] == 2 and s["device_ops"] == 5
    assert s["layer_s"]["spmm"] == 40e-6
    assert s["layer_s"]["dense"] == 14e-6  # gemm_a and the copy under aten::mm
    assert s["layer_s"]["other"] == 2e-6


def test_busy_union_gaps_and_top_ops():
    s = traceparse.analyze(_trace(), steps=2)
    # Busy: [5, 15], [25, 46], [60, 80], [100, 104].
    assert abs(s["busy_s"] - 55e-6) < 1e-12
    assert s["top_device_ops"][0] == ["walker_v9", 40e-6]
    gaps = dict(s["idle_gaps"])
    # Gaps 15-25 (the span open on the main thread), 46-60 and 80-100.
    assert abs(sum(gaps.values()) - 44e-6) < 1e-12
    assert abs(gaps[traceparse.SPMM_SPAN] - 10e-6) < 1e-12


def test_no_device_operation_reads_nothing():
    trace = {"traceEvents": [_x("cpu_op", "aten::mm", 0, 10)]}
    assert traceparse.analyze(trace, steps=1) is None


def test_layer_rule():
    assert traceparse.layer_of(["aten::add", traceparse.SPMM_SPAN]) == "spmm"
    assert traceparse.layer_of(["aten::mm", "x"]) == "dense"
    assert traceparse.layer_of(
        ["autograd::engine::evaluate_function: _SpmmMinMaxBackward"]) == "spmm"
    assert traceparse.layer_of([]) == "other"
