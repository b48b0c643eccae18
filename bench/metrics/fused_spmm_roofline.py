"""block_ell_spmm_fused, y = Â (X W + b): the least time its calls'
work needs at 67 TFLOP/s and 3.35 TB/s (bench/counts.py
fused_spmm_work: 2·n·D·F + 2·nnz·F FLOPs; X, W, b, y and Â as CSR),
over their device time in the profiled epochs, in %."""


def read(ctx):
    p = ctx.profile
    if not p or not p["fused"] or not p["fused"]["kernel_s"]:
        return None
    return 100.0 * p["fused"]["min_s"] / p["fused"]["kernel_s"]
