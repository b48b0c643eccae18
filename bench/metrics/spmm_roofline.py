"""block_ell_spmm on the transposed tiles, the backward Âᵀ G: the least
time its calls' work needs (bench/counts.py spmm_work: 2·nnz·F FLOPs;
G, the output and Â as CSR), over their device time in the profiled
epochs, in %."""


def read(ctx):
    p = ctx.profile
    if not p or not p["spmm"] or not p["spmm"]["kernel_s"]:
        return None
    return 100.0 * p["spmm"]["min_s"] / p["spmm"]["kernel_s"]
