"""Mean bytes of a step's payload (tiles of Â and Âᵀ, features, labels,
masks), in MiB: a count of what the copy moves to the device."""
import statistics


def read(ctx):
    v = ctx.part["payload_bytes"]
    return statistics.fmean(v) / 2 ** 20 if v else None
