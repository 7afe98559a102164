"""Real spherical harmonic transforms (SHT), channels-last, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/ops/sht.py`` (``RealSHT`` and
``InverseRealSHT``) for the default longitude method: the longitude stage is
an explicit real-DFT matrix product and the latitude stage an
associated-Legendre product batched over the azimuthal order m, as the JAX
package leaves them to XLA outside any Pallas kernel.

Spectral tensors use the stacked real layout ``(..., lmax, mmax, C, 2)``
(real and imaginary parts in a trailing axis, the layout of
``torch.view_as_real``), which is the JAX package's ``stacked=True`` output,
so no complex dtype appears anywhere in the port. The matrices are float32
buffers, built once on the host in float64 (``ops/quadrature.py``).

``matmul_dtype`` rounds both operands of every product to that dtype and
keeps the float32 sums, at the JAX package's rounding points
(``ops/matmul.py``): the grid input and the DFT matrix before the longitude
product, its output (after ``out_dtype``) and the Legendre matrix before the
latitude product. ``out_dtype`` rounds each stage's output (JAX's
``_emit``). The two stages are separate methods (``longitude`` and
``latitude``), so the CP rank pipeline can put the K4 kernel between the
DFT and the inverse DFT. With ``kernel_layout=True`` the transform also
holds its Legendre matrix as ``(m, h, l)`` in the matmul dtype
(``analysis_mhl`` / ``synthesis_mhl``), the layout K4 reads, and per m the
first l at which that matrix is non-zero (``analysis_l_first`` /
``synthesis_l_first``, int32, read from the matrix in the matmul dtype: m on
the Legendre grids, where P_l^m = 0 for l < m), from which K4 skips the zero
triangle; both made once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .matmul import as_dtype, einsum, emit
from .quadrature import dft_matrices, sht_matrices

__all__ = ["RealSHT", "InverseRealSHT", "legendre_l_first"]


def legendre_l_first(*mats: torch.Tensor) -> torch.Tensor:
    """Per m, the first l at which any of the ``(m, h, l)`` matrices is
    non-zero (l where all of them vanish), int32 ``(m,)``."""
    nz = torch.stack([(a != 0).any(dim=1) for a in mats]).any(dim=0)  # (m, l)
    first = nz.to(torch.int32).argmax(dim=1).to(torch.int32)
    return torch.where(nz.any(dim=1), first, torch.full_like(first, nz.shape[1]))


class _Transform(nn.Module):
    def __init__(self, nlat: int, nlon: int, lmax: Optional[int], mmax: Optional[int],
                 grid: str, matmul_dtype, kernel_layout: bool, inverse: bool):
        super().__init__()
        self.nlat, self.nlon, self.grid = nlat, nlon, grid
        self.lmax = lmax if lmax is not None else nlat
        self.mmax = mmax if mmax is not None else nlon // 2 + 1
        self.matmul_dtype = as_dtype(matmul_dtype) or torch.float32
        mats = sht_matrices(nlat, grid, self.lmax, self.mmax)
        legendre = mats[1] if inverse else mats[0]
        dft = dft_matrices(nlon, self.mmax)[1 if inverse else 0]
        name = "synthesis" if inverse else "analysis"
        self.register_buffer(name, torch.tensor(legendre, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("dft", torch.tensor(dft, dtype=torch.float32), persistent=False)
        if kernel_layout:
            mhl = torch.tensor(legendre, dtype=torch.float32).permute(2, 0, 1).contiguous() \
                .to(self.matmul_dtype)
            self.register_buffer(f"{name}_mhl", mhl, persistent=False)
            self.register_buffer(f"{name}_l_first", legendre_l_first(mhl), persistent=False)


class RealSHT(_Transform):
    """Forward (analysis) real SHT: grid ``(..., nlat, nlon, C)`` ->
    spectral ``(..., lmax, mmax, C, 2)``, float32 unless ``out_dtype``."""

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None,
                 mmax: Optional[int] = None, grid: str = "equiangular",
                 matmul_dtype="float32", kernel_layout: bool = False):
        super().__init__(nlat, nlon, lmax, mmax, grid, matmul_dtype, kernel_layout, False)

    def longitude(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """DFT stage: ``(..., h, w, c)`` -> ``(..., h, m, c, 2)``."""
        return emit(einsum("...hwc,wmr->...hmcr", x.float(), self.dft, self.matmul_dtype),
                    out_dtype)

    def latitude(self, xf: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """Legendre analysis: ``(..., h, m, c, 2)`` -> ``(..., l, m, c, 2)``."""
        return emit(einsum("...hmcr,hlm->...lmcr", xf, self.analysis, self.matmul_dtype)
                    .contiguous(), out_dtype)

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        return self.latitude(self.longitude(x, out_dtype), out_dtype)


class InverseRealSHT(_Transform):
    """Inverse (synthesis) real SHT: spectral ``(..., lmax, mmax, C, 2)`` ->
    grid ``(..., nlat, nlon, C)``, float32 unless ``out_dtype``."""

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None,
                 mmax: Optional[int] = None, grid: str = "equiangular",
                 matmul_dtype="float32", kernel_layout: bool = False):
        super().__init__(nlat, nlon, lmax, mmax, grid, matmul_dtype, kernel_layout, True)

    def latitude(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """Legendre synthesis: ``(..., l, m, c, 2)`` -> ``(..., h, m, c, 2)``."""
        return emit(einsum("...lmcr,hlm->...hmcr", x, self.synthesis, self.matmul_dtype),
                    out_dtype)

    def longitude(self, y: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """Inverse DFT stage: ``(..., h, m, c, 2)`` -> ``(..., h, w, c)``."""
        return emit(einsum("...hmcr,mwr->...hwc", y, self.dft, self.matmul_dtype), out_dtype)

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        return self.longitude(self.latitude(x, out_dtype), out_dtype)
