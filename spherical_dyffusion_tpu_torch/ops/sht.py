"""Real spherical harmonic transforms (SHT), channels-last, in PyTorch.

Counterpart of ``spherical_dyffusion_tpu/ops/sht.py`` (``RealSHT`` and
``InverseRealSHT``): the longitude stage is an explicit real-DFT matrix
product (``lon_method="matmul"``, the default) or ``torch.fft.rfft`` /
``irfft`` with ``norm="forward"``, truncated to ``mmax`` and zero-padded back
to ``nlon // 2 + 1`` (``lon_method="fft"``); the latitude stage is an
associated-Legendre product batched over the azimuthal order m, or with
``fold_symmetry`` its even/odd-folded form (two products over half the
latitudes, from ``P_l^m(-x) = (-1)^(l+m) P_l^m(x)`` on the symmetric grids),
taken only where ``nlat`` and ``lmax`` are both even and otherwise left for
the unfolded form without a word, as in the JAX package, which leaves all
of this to XLA outside any Pallas kernel.

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
DFT and the inverse DFT.

The folded and FFT paths round where the JAX package's do, which is not
where the default path rounds: the forward transform's longitude stage is
not emitted (only the spectral output is), and the inverse transform of
either path emits nothing and returns float32. The FFT itself computes in
float32; its output is rounded to the matmul dtype for the Legendre
product. With ``kernel_layout=True`` the transform also
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
                 grid: str, matmul_dtype, kernel_layout: bool, inverse: bool,
                 lon_method: str = "matmul", fold_symmetry: bool = False):
        super().__init__()
        if lon_method not in ("matmul", "fft"):
            raise ValueError(f"lon_method {lon_method!r}: 'matmul' or 'fft'")
        self.nlat, self.nlon, self.grid = nlat, nlon, grid
        self.lmax = lmax if lmax is not None else nlat
        self.mmax = mmax if mmax is not None else nlon // 2 + 1
        self.matmul_dtype = as_dtype(matmul_dtype) or torch.float32
        self.lon_fft = lon_method == "fft"
        # the JAX package's gate: both even, else the unfolded form
        self.folded = fold_symmetry and nlat % 2 == 0 and self.lmax % 2 == 0
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


def _m_parity(m: int, device) -> torch.Tensor:
    """``(m, 1, 1)`` booleans: m even, broadcast over (c, 2)."""
    return (torch.arange(m, device=device) % 2 == 0)[:, None, None]


class RealSHT(_Transform):
    """Forward (analysis) real SHT: grid ``(..., nlat, nlon, C)`` ->
    spectral ``(..., lmax, mmax, C, 2)``, float32 unless ``out_dtype``."""

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None,
                 mmax: Optional[int] = None, grid: str = "equiangular",
                 matmul_dtype="float32", kernel_layout: bool = False,
                 lon_method: str = "matmul", fold_symmetry: bool = False):
        super().__init__(nlat, nlon, lmax, mmax, grid, matmul_dtype, kernel_layout, False,
                         lon_method, fold_symmetry)

    def longitude(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """DFT stage: ``(..., h, w, c)`` -> ``(..., h, m, c, 2)``; emitted in
        ``out_dtype`` only on the unfolded matmul path."""
        if self.lon_fft:
            xf = torch.fft.rfft(x.float(), dim=-2, norm="forward")[..., :self.mmax, :]
            return torch.view_as_real(xf)
        y = einsum("...hwc,wmr->...hmcr", x.float(), self.dft, self.matmul_dtype)
        return y if self.folded else emit(y, out_dtype)

    def latitude(self, xf: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """Legendre analysis: ``(..., h, m, c, 2)`` -> ``(..., l, m, c, 2)``."""
        if self.folded:
            return emit(self._folded(xf), out_dtype)
        return emit(einsum("...hmcr,hlm->...lmcr", xf, self.analysis, self.matmul_dtype)
                    .contiguous(), out_dtype)

    def _folded(self, xf: torch.Tensor) -> torch.Tensor:
        """Even/odd-folded analysis over every latitude pair."""
        H2 = self.nlat // 2
        return self.folded_pairs(xf[..., :H2, :, :, :], xf[..., H2:, :, :, :].flip(-4),
                                 slice(0, H2))

    def folded_pairs(self, top: torch.Tensor, bot: torch.Tensor, north) -> torch.Tensor:
        """Even/odd-folded analysis over a subset of the latitude pairs
        (h, nlat - 1 - h), h < nlat / 2: ``top`` ``(..., n, m, c, 2)`` holds
        rows ``north`` (a slice of the northern rows) and ``bot`` their
        mirrors in the same order. With e and o the sum and difference of
        the two (taken in the matmul dtype), the even-l rows contract e for
        even m and o for odd m, the odd-l rows the other; two products over
        the pairs, interleaved back into l: the pairs' part of the sum over
        latitudes, float32 ``(..., lmax, m, c, 2)``."""
        md = self.matmul_dtype
        top, bot = top.to(md), bot.to(md)
        e, o = top + bot, top - bot
        A = self.analysis[north]
        m_even = _m_parity(top.shape[-3], top.device)
        out_e = einsum("...hmcr,hjm->...jmcr", torch.where(m_even, e, o), A[:, 0::2], md)
        out_o = einsum("...hmcr,hjm->...jmcr", torch.where(m_even, o, e), A[:, 1::2], md)
        y = torch.stack([out_e, out_o], dim=-4)  # (..., L/2, 2, M, C, 2)
        return y.reshape(y.shape[:-5] + (self.lmax,) + y.shape[-3:])

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        return self.latitude(self.longitude(x, out_dtype), out_dtype)


class InverseRealSHT(_Transform):
    """Inverse (synthesis) real SHT: spectral ``(..., lmax, mmax, C, 2)`` ->
    grid ``(..., nlat, nlon, C)``, float32 unless ``out_dtype`` (which only
    the unfolded matmul path emits)."""

    def __init__(self, nlat: int, nlon: int, lmax: Optional[int] = None,
                 mmax: Optional[int] = None, grid: str = "equiangular",
                 matmul_dtype="float32", kernel_layout: bool = False,
                 lon_method: str = "matmul", fold_symmetry: bool = False):
        super().__init__(nlat, nlon, lmax, mmax, grid, matmul_dtype, kernel_layout, True,
                         lon_method, fold_symmetry)

    @property
    def _emits(self) -> bool:
        return not (self.folded or self.lon_fft)

    def latitude(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """Legendre synthesis: ``(..., l, m, c, 2)`` -> ``(..., h, m, c, 2)``."""
        if self.folded:
            return self._folded(x)
        y = einsum("...lmcr,hlm->...hmcr", x, self.synthesis, self.matmul_dtype)
        return emit(y, out_dtype) if self._emits else y

    def _folded(self, x: torch.Tensor) -> torch.Tensor:
        """Even/odd-folded synthesis (the adjoint of the folded analysis) of
        every latitude."""
        return self.folded_rows(x, slice(0, self.nlat))

    def folded_rows(self, x: torch.Tensor, rows: slice) -> torch.Tensor:
        """Even/odd-folded synthesis of the latitudes ``rows`` (a contiguous
        slice): with E and O the even- and odd-l syntheses at the northern
        rows h < nlat / 2 that these rows mirror to, a northern row is E + O
        and a southern row nlat - 1 - h is (-1)^m (E - O) at h;
        ``(..., n, m, c, 2)`` float32."""
        H, H2, md = self.nlat, self.nlat // 2, self.matmul_dtype
        a, b = rows.start, rows.stop
        n_top = max(min(b, H2) - a, 0)  # the northern rows of the slice
        s0, s1 = max(a, H2), b  # its southern rows, which mirror to H-s1 .. H-1-s0
        spans = ([(a, a + n_top)] if n_top else []) + ([(H - s1, H - s0)] if s1 > s0 else [])
        lo, hi = min(p for p, _ in spans), max(q for _, q in spans)
        S = self.synthesis[lo:hi]
        E = einsum("...jmcr,hjm->...hmcr", x[..., 0::2, :, :, :], S[:, 0::2], md)
        O = einsum("...jmcr,hjm->...hmcr", x[..., 1::2, :, :, :], S[:, 1::2], md)
        sign = torch.where(_m_parity(x.shape[-3], x.device), 1.0, -1.0)
        top = (E + O)[..., a - lo:a - lo + n_top, :, :, :]
        bottom = ((E - O) * sign)[..., H - s1 - lo:H - s0 - lo, :, :, :].flip(-4)
        return torch.cat([top, bottom], dim=-4)

    def longitude(self, y: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        """Inverse DFT stage: ``(..., h, m, c, 2)`` -> ``(..., h, w, c)``."""
        if self.lon_fft:
            yc = torch.view_as_complex(y.float().contiguous())
            pad = self.nlon // 2 + 1 - self.mmax
            if pad > 0:
                yc = torch.nn.functional.pad(yc, (0, 0, 0, pad))
            return torch.fft.irfft(yc, n=self.nlon, dim=-2, norm="forward")
        out = einsum("...hmcr,mwr->...hwc", y, self.dft, self.matmul_dtype)
        return emit(out, out_dtype) if self._emits else out

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None):
        return self.longitude(self.latitude(x, out_dtype), out_dtype)
