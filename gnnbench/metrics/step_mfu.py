"""The step's model operations over the step time times the published
float32 peak (67 TFLOP/s), in percent.  Operations: the dense products
forward and backward and 2·nnz·K for every SpMM, counted from the
configuration's shapes; the step time is the traced run's own, from the
host clock over its steps before the profiler starts."""

from gnnbench.roofline import H100_F32_GFLOPS, spmm_flops


def read(run):
    if "traced_step_s" not in run:
        return None
    cfg, kind = run["config"], run["adapter"]
    flops = kind.dense_flops(cfg, run["n"]) + sum(
        spmm_flops(nnz, k) for _, nnz, k in kind.spmm_calls(cfg, run["n"], run["nnz"]))
    return 100.0 * flops / (run["traced_step_s"] * H100_F32_GFLOPS * 1e9)
