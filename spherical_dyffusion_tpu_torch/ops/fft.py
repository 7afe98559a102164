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

Each transform is two stages, as the SHT's are, in the JAX package's
order. The forward's ``longitude`` is the real FFT over W truncated to
``mmax``, ``(..., h, W, c)`` -> ``(..., h, mmax, c, 2)``, and its
``latitude`` the FFT over H and the kept rows. The inverse's ``latitude``
scatters into the full spectrum and inverts the FFT over H, ``(..., lmax,
mmax, c, 2)`` -> ``(..., H, W // 2 + 1, c, 2)``, and its ``longitude`` the
inverse real FFT over W. ``forward`` is their composition, so a grid split
over latitudes runs the longitude stage on its own rows
(``parallel/distributed_sht.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["RealFFT2", "InverseRealFFT2"]


def _complex(t: torch.Tensor) -> torch.Tensor:
    """The stacked real layout ``(..., 2)`` as a complex view, copied first
    only where its strides do not allow the view."""
    t = t.float()
    if t.stride(-1) != 1 or t.storage_offset() % 2 or any(s % 2 for s in t.stride()[:-1]):
        t = t.contiguous()
    return torch.view_as_complex(t)


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

    def longitude(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """``(..., h, nlon, c)`` -> ``(..., h, mmax, c, 2)``."""
        xf = torch.fft.rfft(x.float(), dim=-2, norm="ortho")[..., :self.mmax, :]
        return torch.view_as_real(xf)

    def latitude(self, xf: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """``(..., nlat, m, c, 2)`` -> ``(..., lmax, m, c, 2)``."""
        xf = torch.view_as_real(torch.fft.fft(_complex(xf), dim=-3, norm="ortho"))
        parts = [xf[..., :self.lpos, :, :, :]]
        if self.lneg > 0:
            parts.append(xf[..., -self.lneg:, :, :, :])
        return torch.cat(parts, dim=-4)

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        return self.latitude(self.longitude(x))


class InverseRealFFT2(_FFT2):
    """Spectral ``(..., lmax, mmax, C, 2)`` -> grid ``(..., nlat, nlon, C)``
    float32: the kept frequencies scattered back into the full spectrum
    (zeros elsewhere), inverse FFT over latitude, inverse real FFT over
    longitude."""

    def latitude(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """``(..., lmax, mmax, c, 2)`` -> ``(..., nlat, nlon // 2 + 1, c, 2)``."""
        x = x.float()
        full = x.new_zeros(x.shape[:-4] + (self.nlat, self.nlon // 2 + 1) + x.shape[-2:])
        full[..., :self.lpos, :self.mmax, :, :] = x[..., :self.lpos, :, :, :]
        if self.lneg > 0:
            full[..., -self.lneg:, :self.mmax, :, :] = x[..., self.lpos:, :, :, :]
        out = torch.fft.ifft(torch.view_as_complex(full), dim=-3, norm="ortho")
        return torch.view_as_real(out)

    def longitude(self, y: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """``(..., h, nlon // 2 + 1, c, 2)`` -> ``(..., h, nlon, c)``."""
        return torch.fft.irfft(_complex(y), n=self.nlon, dim=-2, norm="ortho")

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        return self.longitude(self.latitude(x))
