from pbmm_tpu.spectral.fft import (
    fft2_centered,
    ifft2_centered,
    irfft2_half,
    rfft2_half,
)

__all__ = [
    "fft2_centered",
    "ifft2_centered",
    "rfft2_half",
    "irfft2_half",
]
