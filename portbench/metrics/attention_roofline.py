"""Kernel H's (flash attention's) least time at its calls' shapes over its
device time in the traced window, in percent: one call a layer for every
batch padded beyond 1024 tokens, the encoder's flash route."""

from portbench.lib.work import attention_bound_s

NAME = "attention_t5_kernel<2"
FLASH_ABOVE = 1024


def read(run):
    batches = run.info.get("batches")
    if run.trace is None or not batches:
        return None
    busy = sum(e - s for name, s, e in run.trace.kernels if NAME in name)
    if busy <= 0:
        return None
    calls = sum(1 for c in run.calls if not c.get("failed"))
    cfg = run.config
    bound = calls * cfg["num_layers"] * sum(
        attention_bound_s(rows, cfg["num_heads"], length, cfg["d_kv"])
        for rows, length in batches if length > FLASH_ABOVE)
    return 100.0 * bound / busy
