"""Published peaks of one NVIDIA H100 SXM at 700 W, and the least time a
piece of work could take on it. Frozen: every roofline share of the
benchmark divides one of these bounds by a measured device time.

Dense rates without sparsity, from NVIDIA's data sheet: 67 TFLOP/s fp32
outside the tensor cores, 495 tf32, 989 bf16, 1979 int8 TOP/s, HBM at
3.35 TB/s. int32: 132 SMs x 64 INT32 lanes a clock (the Hopper SM's four
partitions of 16; NVIDIA's Hopper architecture white paper) x 1980 MHz,
the H100 SXM's maximum SM clock. A card set below 700 W runs slower than
these; every result names the card's power limit beside its shares.
"""

PEAK_OPS = {
    "fp32": 67e12,
    "tf32": 495e12,
    "bf16": 989e12,
    "int8": 1979e12,
    "int32": 132 * 64 * 1980e6,
}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, kind: str, nbytes: float) -> float:
    """Least seconds the card could take: `ops` operations at the peak for
    `kind` operands, or `nbytes` (each input read once, each output written
    once) at the memory rate, whichever is larger."""
    return max(ops / PEAK_OPS[kind], nbytes / HBM_BYTES_PER_S)
