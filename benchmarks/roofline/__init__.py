"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates) and the
least time a piece of work can take on it.  A kernel's counts of bytes
and operations live in roofline/<kernel>.py, computed from the
algorithm's shapes and never from an implementation's padding."""

HBM_BYTES_PER_S = 3.35e12     # device memory
NONTENSOR_OPS_PER_S = 67e12   # float32 / integer outside the tensor cores


def bound_ms(nbytes: float, nops: float) -> float:
    """Least milliseconds for the work: bytes over the memory rate or
    operations over the non-tensor rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, nops / NONTENSOR_OPS_PER_S) * 1e3
