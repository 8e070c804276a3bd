"""Kernel G's (the fused FFN's) least time at its calls' shapes over its
device time in the traced window, in percent: one call a layer and batch,
over the batch's rows x padded length tokens."""

from portbench.lib.work import ffn_bound_s

NAMES = ("::rms_norm_kernel<", "::gemm_kernel<")


def read(run):
    batches = run.info.get("batches")
    if run.trace is None or not batches:
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels
               if any(n in name.lower() for n in NAMES))
    if busy <= 0:
        return None
    calls = sum(1 for c in run.calls if not c.get("failed"))
    cfg = run.config
    bound = calls * cfg["num_layers"] * sum(
        ffn_bound_s(rows * length, cfg["d_model"], cfg["d_ff"])
        for rows, length in batches)
    return 100.0 * bound / busy
