"""Planar real FFT transforms with the SHT interface, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/ops/fft.py`` (``RealFFT2`` and
``InverseRealFFT2``), the transforms of ``SFNOConfig.spectral_transform =
"fft"``: a 2-D FFT with ``norm="ortho"`` over (H, W) of channels-last
``(..., H, W, C)``, keeping the ``mmax`` lowest non-negative zonal
frequencies and the ``lmax`` lowest meridional ones, ``ceil(lmax / 2)``
non-negative then ``floor(lmax / 2)`` negative. The JAX package computes
these with ``jnp.fft`` outside any kernel; here they are ``torch.fft``
(cuFFT on the card), and every complex result is taken apart at once with
``torch.view_as_real``, so the spectral tensors are the stacked real layout
``(..., lmax, mmax, C, 2)`` of ``ops/sht.py``. Both compute in float32 and
take no matmul or IO dtype: the JAX package ignores them here too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["RealFFT2", "InverseRealFFT2"]


class _FFT2(nn.Module):
    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None,
                 mmax: Optional[int] = None):
        super().__init__()
        self.nlat, self.nlon, self.grid = nlat, nlon, "fft"
        self.lmax = lmax if lmax is not None else nlat
        self.mmax = mmax if mmax is not None else nlon // 2 + 1
        # the lowest |frequencies|: ceil(lmax/2) non-negative, floor(lmax/2) negative
        self.lpos, self.lneg = (self.lmax + 1) // 2, self.lmax // 2


class RealFFT2(_FFT2):
    """Grid ``(..., nlat, nlon, C)`` -> spectral ``(..., lmax, mmax, C, 2)``
    float32."""

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        xf = torch.fft.rfft(x.float(), dim=-2, norm="ortho")[..., :self.mmax, :]
        xf = torch.view_as_real(torch.fft.fft(xf, dim=-3, norm="ortho"))
        parts = [xf[..., :self.lpos, :, :, :]]
        if self.lneg > 0:
            parts.append(xf[..., -self.lneg:, :, :, :])
        return torch.cat(parts, dim=-4)


class InverseRealFFT2(_FFT2):
    """Spectral ``(..., lmax, mmax, C, 2)`` -> grid ``(..., nlat, nlon, C)``
    float32: the kept frequencies scattered back into the full spectrum
    (zeros elsewhere), inverse FFT over latitude, inverse real FFT over
    longitude."""

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        x = x.float()
        full = x.new_zeros(x.shape[:-4] + (self.nlat, self.nlon // 2 + 1) + x.shape[-2:])
        full[..., :self.lpos, :self.mmax, :, :] = x[..., :self.lpos, :, :, :]
        if self.lneg > 0:
            full[..., -self.lneg:, :self.mmax, :, :] = x[..., self.lpos:, :, :, :]
        out = torch.fft.ifft(torch.view_as_complex(full), dim=-3, norm="ortho")
        return torch.fft.irfft(out, n=self.nlon, dim=-2, norm="ortho")
