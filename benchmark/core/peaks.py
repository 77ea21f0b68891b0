"""The chip's published peaks (NVIDIA H100 SXM data sheet, at its 700 W
limit).  Only a bytes bound is stated: the data sheet gives no peak for
the integer operations these kernels do."""

HBM_BYTES_PER_S = 3.35e12


def roofline_pct(nbytes: float, kernel_s) -> float | None:
    """The share of its bytes bound that a kernel reached, in percent, or
    None when there is no kernel time or no byte to count."""
    if not kernel_s or not nbytes:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / kernel_s
