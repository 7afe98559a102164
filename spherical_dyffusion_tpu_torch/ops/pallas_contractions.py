"""K1: the dhconv spectral contraction as a hand-written CUDA kernel.

Counterpart of ``spherical_dyffusion_tpu/ops/pallas_contractions.py``
(``dhconv_pallas`` and its Pallas forward ``_pallas_forward``). The kernel is
``csrc/dhconv.cu``: the complex product as one real GEMM over K = 2 CI on the
TF32 tensor cores, with each operand split into two TF32 parts (3xTF32) so
that the result keeps float32 accuracy; its source note says what bounds it
on the H100 and how it is tiled. ``dhconv`` launches it for CUDA tensors and
counts the launch in ``dhconv.launches``; for CPU tensors it computes the
plain version, ``contract_dhconv`` (the same four real products in
``torch.einsum``). There is no fallback: a CUDA tensor that the kernel cannot
take raises.

Layout: x is the interleaved ``(..., L, M, CI, 2)`` float32 layout of
``ops/sht.py`` (what ``torch.view_as_real`` gives for complex64); the output
is ``(..., L, M, CO, 2)`` float32 in the same layout. The weight keeps the
model's ``(CI, CO, L, 2)`` layout; the kernel reads it as an image made once
per model (``dhconv_weight_image``): per l, per tile of 128 co and chunk of 16
ci, the K-major tile ``(co, (ci, re/im))`` in the 128-byte swizzle that the
tensor cores read, split into its TF32 hi and lo parts (twice the weight's
bytes). ``WeightImageCache`` holds the image beside the weight and makes it
again when the weight changes.

Forward only: the backward pass (``_dhconv_rr_bwd`` in the JAX package) comes
with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _cuda
from .contractions import contract_dhconv

__all__ = ["dhconv", "dhconv_plain", "dhconv_weight_image", "dhconv_weight_image_plain",
           "split_tf32", "WeightImageCache", "IMAGE_CO", "IMAGE_CI"]

dhconv_plain = contract_dhconv

IMAGE_CO = 128  # co per column tile of the image: the kernel's N
IMAGE_CI = 16   # ci per chunk: K = 32 floats, one 128-byte row


def split_tf32(a: torch.Tensor):
    """``(hi, lo)`` float32 with ``hi`` = a rounded to TF32 (to nearest, ties
    away from zero: half a TF32 ulp added to the bits, the 13 low bits
    cleared) and ``lo`` = ``a - hi`` (exact) rounded the same way: the split
    of K1's 3xTF32 products, bit for bit what the kernel computes."""

    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a.float())
    return hi, rna(a.float() - hi)


def _image_shape(CI: int, CO: int, L: int):
    return (L, -(-CO // IMAGE_CO), -(-CI // IMAGE_CI), 2, IMAGE_CO, 2 * IMAGE_CI)


def dhconv_weight_image_plain(w: torch.Tensor) -> torch.Tensor:
    """The K1 weight image of w ``(CI, CO, L, 2)``: a zero-padded permutation
    to ``(L, CO/128, CI/16, 128, 32)`` (co rows, (ci, re/im) pairs along K),
    each row's eight 16-byte chunks swizzled (storage chunk s holds logical
    chunk s ^ (row % 8)), then split by ``split_tf32``; returns
    ``(L, CO/128, CI/16, 2, 128, 32)`` float32, hi before lo."""
    CI, CO, L, _ = w.shape
    shape = _image_shape(CI, CO, L)
    nct, nch = shape[1], shape[2]
    wk = w.new_zeros((L, nct * IMAGE_CO, nch * IMAGE_CI, 2), dtype=torch.float32)
    wk[:, :CO, :CI] = w.float().permute(2, 1, 0, 3)
    t = wk.reshape(L, nct, IMAGE_CO, nch, 2 * IMAGE_CI).permute(0, 1, 3, 2, 4)
    n = torch.arange(IMAGE_CO, device=w.device)[:, None]
    chunk = torch.arange(8, device=w.device)[None, :] ^ (n % 8)
    idx = (chunk[:, :, None] * 4 + torch.arange(4, device=w.device)).reshape(IMAGE_CO, -1)
    t = torch.gather(t, -1, idx.expand(t.shape))
    hi, lo = split_tf32(t)
    return torch.stack([hi, lo], dim=3).contiguous()


def dhconv_weight_image(w: torch.Tensor) -> torch.Tensor:
    """The K1 weight image of w ``(CI, CO, L, 2)`` float32: built by one small
    kernel on the card (counted in ``dhconv_weight_image.launches``), by
    ``dhconv_weight_image_plain`` on the CPU."""
    if w.device.type == "cpu":
        return dhconv_weight_image_plain(w)
    if w.device.type != "cuda":
        raise ValueError(f"dhconv_weight_image: unsupported device {w.device}")
    if w.dtype != torch.float32 or w.dim() != 4 or w.shape[-1] != 2 or not w.is_contiguous():
        raise ValueError(f"dhconv_weight_image: a contiguous float32 (CI, CO, L, 2) weight "
                         f"required, got {w.dtype} {tuple(w.shape)}")
    CI, CO, L, _ = w.shape
    img = torch.empty(_image_shape(CI, CO, L), device=w.device, dtype=torch.float32)
    lib = _cuda.library()
    _cuda.check(lib.sdt_dhconv_weight_image(w.data_ptr(), img.data_ptr(), L, CI, CO,
                                            _cuda.stream_ptr(w.device)), "dhconv_weight_image")
    dhconv_weight_image.launches += 1
    return img


dhconv_weight_image.launches = 0


class WeightImageCache:
    """The K1 weight image of one weight tensor, made on first use and made
    again whenever the weight changes: the key is the weight's device, data
    pointer, version counter and shape, so an in-place update
    (``load_state_dict``, an optimizer step) or a move to another device
    rebuilds it. Held, not registered, by the module that owns the weight:
    it is derived and never saved."""

    def __init__(self):
        self.key = None
        self.image: Optional[torch.Tensor] = None

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        key = (w.device, w.data_ptr(), w._version, tuple(w.shape))
        if key != self.key:
            self.image = None  # free the old image before the new one is made
            self.image = dhconv_weight_image(w)
            self.key = key
        return self.image


def dhconv(x: torch.Tensor, w: torch.Tensor,
           image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x ``(..., L, M, CI, 2)``, w ``(CI, CO, L, 2)`` -> ``(..., L, M, CO, 2)``.

    ``image``: w's ``dhconv_weight_image``, made once by the caller (see
    ``WeightImageCache``); without it a CUDA call makes one for itself."""
    if x.device.type == "cpu":
        return dhconv_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dhconv: unsupported device {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"dhconv: float32 inputs required, got {x.dtype}, {w.dtype}")
    if w.device != x.device:
        raise ValueError("dhconv: x and w must lie on the same device")
    if x.dim() < 4 or x.shape[-1] != 2 or w.dim() != 4 or w.shape[-1] != 2:
        raise ValueError(f"dhconv: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    L, M, CI = x.shape[-4:-1]
    if w.shape[0] != CI or w.shape[2] != L:
        raise ValueError(f"dhconv: w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("dhconv: x must be contiguous")
    CO = w.shape[1]
    lead = x.shape[:-4]
    B = x.numel() // (L * M * CI * 2)
    if B * L > 65535:
        raise ValueError(f"dhconv: batch x L = {B * L} exceeds the kernel grid (65535)")
    if image is None:
        image = dhconv_weight_image(w)
    if image.shape != _image_shape(CI, CO, L) or image.dtype != torch.float32 \
            or image.device != x.device or not image.is_contiguous():
        raise ValueError(f"dhconv: image {image.dtype} {tuple(image.shape)} is not the "
                         f"weight image of w {tuple(w.shape)}")
    y = torch.empty(lead + (L, M, CO, 2), device=x.device, dtype=torch.float32)
    if B == 0:
        return y
    lib = _cuda.library()
    _cuda.check(lib.sdt_dhconv_fwd(x.data_ptr(), image.data_ptr(), y.data_ptr(), B, L, M, CI,
                                   CO, _cuda.stream_ptr(x.device)), "dhconv")
    dhconv.launches += 1
    return y


dhconv.launches = 0
