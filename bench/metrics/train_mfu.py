"""The matmul FLOPs the steps need (bench/counts.py step_flops, from
each batch's n and nnz and the widths) over the seconds they took,
outside the profiled epochs, as a share of the H100's fp32 CUDA-core
peak (TF32 is off in the port)."""
from bench.counts import PEAK_FLOPS_FP32


def read(ctx):
    flops = ctx.part.get("flops")
    if not flops or not ctx.part["seconds"] or not ctx.cuda:
        return None
    return 100.0 * sum(flops) / ctx.part["seconds"] / PEAK_FLOPS_FP32
