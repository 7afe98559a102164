"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function and
its counterpart in ``spherical_dyffusion_tpu_torch``. On the CPU the port's
kernel wrappers compute their plain versions; the Pallas kernels run in
interpret mode, as the JAX package's own tests run them. Tolerances are for
float32 on both sides: the two frameworks sum in different orders, so
results agree to a few float32 ulps of the summed magnitude, not bit for bit.
"""

import ast
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherical_dyffusion_tpu.ops import quadrature as jq
from spherical_dyffusion_tpu.ops.contractions import contract_dhconv as jax_contract_dhconv
from spherical_dyffusion_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from spherical_dyffusion_tpu.ops.pallas_contractions import dhconv_pallas
from spherical_dyffusion_tpu.ops.sht import InverseRealSHT as JInverseRealSHT
from spherical_dyffusion_tpu.ops.sht import RealSHT as JRealSHT
from spherical_dyffusion_tpu_torch.models.modules import DropPath, QuantizedDropout
from spherical_dyffusion_tpu_torch.ops import quadrature as tq
from spherical_dyffusion_tpu_torch.ops.contractions import contract, contract_dhconv
from spherical_dyffusion_tpu_torch.ops.fused_mlp import (
    fused_mlp,
    philox4x32,
    philox_bits,
    philox_layout,
    quantized_dropout,
    weight_image_plain,
)
from spherical_dyffusion_tpu_torch.ops.pallas_contractions import dhconv, dhconv_plain
from spherical_dyffusion_tpu_torch.ops.sht import InverseRealSHT, RealSHT

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- quadrature

@pytest.mark.parametrize("call", [
    ("legendre_gauss_nodes_weights", (12,)),
    ("clenshaw_curtiss_nodes_weights", (13,)),
    ("equiangular_cell_centered_nodes_weights", (10,)),
    ("grid_nodes_weights", ("equiangular", 16)),
    ("grid_nodes_weights", ("legendre-gauss", 16)),
    ("precompute_legendre", (9, 7, np.linspace(-0.9, 0.9, 11))),
    ("dft_matrices", (32, 17)),
    ("dft_matrices", (31, 12)),
    ("sht_matrices", (16, "equiangular", 16, 17)),
    ("sht_matrices", (16, "legendre-gauss", 12, 10)),
])
def test_quadrature_copy_is_pinned_to_original(call):
    """The port's numpy copy must return exactly the original's arrays."""
    name, args = call
    got = getattr(tq, name)(*args)
    want = getattr(jq, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------- SHT

@pytest.mark.parametrize("grid", ["equiangular", "legendre-gauss"])
@pytest.mark.parametrize("modes", [None, (10, 9)])
def test_sht_and_isht_match_jax(grid, modes):
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 16, 32, 5)).astype(np.float32)
    lmax, mmax = modes or (None, None)
    jf = JRealSHT.create(16, 32, lmax, mmax, grid=grid)
    ji = JInverseRealSHT.create(16, 32, lmax, mmax, grid=grid)
    tf = RealSHT(16, 32, lmax, mmax, grid=grid)
    ti = InverseRealSHT(16, 32, lmax, mmax, grid=grid)
    jz = np.asarray(jf(jnp.asarray(x)))
    tz = tf(torch.from_numpy(x)).numpy()
    assert tz.shape == jz.shape + (2,)
    # sums of 32 (DFT) then 16 (Legendre) float32 terms of O(1) values
    np.testing.assert_allclose(tz[..., 0], jz.real, rtol=0, atol=2e-5)
    np.testing.assert_allclose(tz[..., 1], jz.imag, rtol=0, atol=2e-5)
    jy = np.asarray(ji(jnp.asarray(jz)))
    ty = ti(torch.from_numpy(tz)).numpy()
    np.testing.assert_allclose(ty, jy, rtol=0, atol=5e-5)


# ----------------------------------------------------------------- K1 dhconv

def _dhconv_inputs(lead=(2,), L=8, M=9, CI=6, CO=5, seed=1):
    r = np.random.default_rng(seed)
    x = r.standard_normal(lead + (L, M, CI, 2)).astype(np.float32)
    w = (r.standard_normal((CI, CO, L, 2)) * 0.3).astype(np.float32)
    return x, w


@pytest.mark.parametrize("lead", [(2,), (2, 3)])
def test_dhconv_plain_matches_jax_contract_and_pallas(lead):
    x, w = _dhconv_inputs(lead)
    xc = jnp.asarray(x[..., 0] + 1j * x[..., 1], jnp.complex64)
    got = dhconv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == lead + (8, 9, 5, 2)
    for ref in (jax_contract_dhconv(xc, jnp.asarray(w)),
                dhconv_pallas(xc, jnp.asarray(w), interpret=True)):
        ref = np.asarray(ref)
        # six-term float32 sums of O(1) products
        np.testing.assert_allclose(got[..., 0], ref.real, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[..., 1], ref.imag, rtol=0, atol=1e-5)


def test_contract_dispatch_and_wrapper_route_cpu_to_plain():
    x, w = _dhconv_inputs()
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = dhconv.launches
    ref = dhconv_plain(xt, wt)
    torch.testing.assert_close(contract(xt, wt, use_pallas=True), ref, rtol=0, atol=0)
    torch.testing.assert_close(contract(xt, wt, use_pallas=False), contract_dhconv(xt, wt),
                               rtol=0, atol=0)
    assert dhconv.launches == before  # a CPU tensor never counts as a launch
    with pytest.raises(ValueError, match="unsupported device"):
        dhconv(xt.to("meta"), wt.to("meta"))


# ------------------------------------------------------------- K2 fused MLP

def _mlp_inputs(N=40, C=12, Hd=24, seed=2):
    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return f(N, C), f(C, Hd), f(Hd), f(Hd, C), f(C), f(N, C)


@pytest.mark.parametrize("exact_gelu", [False, True])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("tile_rows", [8, 1024])
def test_fused_mlp_plain_matches_jax_kernel(exact_gelu, with_residual, tile_rows):
    """Dropout off; N = 40 rows with tile_rows 8 leaves no partial tile, so
    use 43 rows there to make the JAX kernel's last tile partial."""
    x, w1, b1, w2, b2, res = _mlp_inputs(N=43 if tile_rows == 8 else 40)
    ref = jax_fused_mlp(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
                        jnp.asarray(b2), residual=jnp.asarray(res) if with_residual else None,
                        exact_gelu=exact_gelu, tile_rows=tile_rows, interpret=True)
    got = fused_mlp(torch.from_numpy(x), torch.from_numpy(w1), torch.from_numpy(b1),
                    torch.from_numpy(w2), torch.from_numpy(b2),
                    residual=torch.from_numpy(res) if with_residual else None,
                    exact_gelu=exact_gelu)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


@pytest.mark.parametrize("x_dtype,res_dtype", [
    ("bfloat16", "float32"), ("float32", "bfloat16"), ("bfloat16", None),
    ("bfloat16", "bfloat16")])
def test_fused_mlp_plain_dtype_promotion_matches_jax(x_dtype, res_dtype):
    """Output dtype is promote(x, residual); the hidden tensor is rounded to
    x's dtype between the products in both. Where the output is bf16 the
    values agree within three bf16 ulps of the O(1) outputs (2e-2): the two
    sides may round a hidden value that lies near a bf16 tie differently."""
    x, w1, b1, w2, b2, res = _mlp_inputs()
    jx = jnp.asarray(x, x_dtype)
    jres = jnp.asarray(res, res_dtype) if res_dtype else None
    ref = jax_fused_mlp(jx, jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2),
                        jnp.asarray(b2), residual=jres, tile_rows=8, interpret=True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, x_dtype))
    tres = (torch.from_numpy(np.array(jres.astype(jnp.float32))).to(getattr(torch, res_dtype))
            if res_dtype else None)
    got = fused_mlp(tx, torch.from_numpy(w1), torch.from_numpy(b1), torch.from_numpy(w2),
                    torch.from_numpy(b2), residual=tres)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    atol = 2e-6 if got.dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)


def test_fused_mlp_validation():
    x, w1, b1, w2, b2, _ = _mlp_inputs()
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    with pytest.raises(ValueError, match="requires a seed"):
        fused_mlp(*args, drop_rate=0.5)
    with pytest.raises(ValueError, match="keep-nothing"):
        fused_mlp(*args, seed=0, drop_rate=0.999)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp(*[a.to("meta") for a in args])


# --------------------------------------------------------------- dropout RNG

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_matches_known_answers(counter, key, want):
    """Philox4x32-10 known-answer vectors (Salmon et al., Random123)."""
    got = philox4x32(tuple(torch.tensor([c]) for c in counter), key)
    assert tuple(int(g) for g in got) == want


def _four_sigma(p, n):
    return 4.0 * math.sqrt(p * (1 - p) / n)


def test_quantized_dropout_keep_rate_and_unbiased_mean():
    """t = round(0.9 * 256) = 230: keep rate within 4 sigma of 230/256 and
    the mean of qdrop(1) within 4 sigma of 1; the two streams differ."""
    t, n = 230, 256 * 512
    ones = torch.ones(256, 512)
    y = quantized_dropout(ones, t, seed=1234)
    p = t / 256
    assert abs((y > 0).float().mean().item() - p) < _four_sigma(p, n)
    sigma_mean = (256 / t) * math.sqrt(p * (1 - p) / n)
    assert abs(y.mean().item() - 1.0) < 4 * sigma_mean
    assert set(torch.unique(y).tolist()) == {0.0, torch.tensor(256 / t).item()}
    b0 = philox_bits(1234, 64, 64, 0)
    assert not torch.equal(b0, philox_bits(1234, 64, 64, 1))
    assert not torch.equal(b0, philox_bits(1235, 64, 64, 0))
    assert torch.equal(b0, philox_bits(1234, 64, 64, 0))


@pytest.mark.parametrize("rows,cols", [(16, 32), (37, 83), (130, 200)])
def test_philox_layout_is_injective_on_a_ragged_grid(rows, cols):
    """No (counter, byte) serves two elements, on whole and ragged 16 x 32
    blocks; each counter serves at most 16 elements (a whole block: exactly
    16) and the counters stay inside the grid the kernels evaluate."""
    c0, c1, byte = (v.expand(rows, cols).reshape(-1) for v in philox_layout(rows, cols))
    assert int(byte.min()) == 0 and int(byte.max()) == 15
    assert int(c0.max()) < -(-cols // 32) * 4 and int(c1.max()) < -(-rows // 16) * 8
    key = (c0 * 4096 + c1) * 16 + byte
    assert torch.unique(key).numel() == rows * cols
    _, per_counter = torch.unique(c0 * 4096 + c1, return_counts=True)
    assert int(per_counter.max()) == 16 and int(per_counter.min()) >= 1
    if rows % 16 == 0 and cols % 32 == 0:
        assert bool((per_counter == 16).all())


def test_philox_bits_follow_the_documented_map():
    """philox_bits against single Philox calls at the counter and byte that
    the docstring (and the kernel's source note) give, seed above 2**32."""
    seed, rows, cols, stream = 0x1234_5678_9ABC, 45, 70, 1
    bits = philox_bits(seed, rows, cols, stream)
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for r, c in [(0, 0), (0, 1), (8, 0), (7, 6), (15, 31), (16, 32), (44, 69), (23, 45)]:
        counter = ((c // 32) * 4 + (c % 8) // 2, (r // 16) * 8 + r % 8, stream, 0)
        words = philox4x32(tuple(torch.tensor([v]) for v in counter), key)
        b = 4 * ((c % 32) // 8) + 2 * (c % 2) + (r % 16) // 8
        assert int(bits[r, c]) == (int(words[b // 4]) >> (8 * (b % 4))) & 255


@pytest.mark.parametrize("t", [230, 128, 13])
def test_quantized_dropout_keep_rate_on_a_ragged_grid(t):
    """Keep rate within 4 sigma of t / 256 for both streams on a grid that
    is not a whole number of 16 x 32 blocks."""
    x = torch.ones(301, 77)
    p, n = t / 256, x.numel()
    for stream in (0, 1):
        kept = (quantized_dropout(x, t, seed=99, stream=stream) > 0).float().mean().item()
        assert abs(kept - p) < _four_sigma(p, n)


@pytest.mark.parametrize("C,Hd,C2", [(256, 512, 256), (64, 128, 64), (48, 80, 32)])
def test_weight_image_is_the_swizzled_permutation(C, Hd, C2):
    """weight_image_plain holds every weight once and zeros elsewhere, each weight
    at the place the bf16 kernel reads it: chunk j of 64 hidden units, W1
    part (input block kb, hidden unit n, input k) then W2 part (output n,
    hidden unit k), element (row, k) of a 64-wide block at
    row * 64 + ((k // 8) ^ (row % 8)) * 8 + k % 8."""
    w1 = torch.arange(1, C * Hd + 1, dtype=torch.float64).reshape(C, Hd)
    w2 = torch.arange(C * Hd + 1, C * Hd + Hd * C2 + 1, dtype=torch.float64).reshape(Hd, C2)
    img = weight_image_plain(w1, w2)
    Cp, nch = -(-C // 64) * 64, -(-Hd // 64)
    assert img.shape == (nch, Cp * 64 + 256 * 64)
    nonzero = img[img != 0]
    assert nonzero.numel() == C * Hd + Hd * C2
    assert torch.equal(torch.sort(nonzero).values, torch.arange(1, C * Hd + Hd * C2 + 1,
                                                                 dtype=torch.float64))
    flat = img.numpy()
    swz = lambda row, k: row * 64 + ((k // 8) ^ (row % 8)) * 8 + k % 8  # noqa: E731
    ks, us = np.meshgrid(np.arange(C), np.arange(Hd), indexing="ij")
    j, n = us // 64, us % 64
    got = flat[j, (ks // 64) * 4096 + swz(n, ks % 64)]
    np.testing.assert_array_equal(got, w1.numpy())
    us, outs = np.meshgrid(np.arange(Hd), np.arange(C2), indexing="ij")
    got = flat[us // 64, Cp * 64 + swz(outs, us % 64)]
    np.testing.assert_array_equal(got, w2.numpy())


def test_fused_mlp_dropout_statistics():
    """With W1 = I, b1 = 1 and exact gelu, h = gelu(1 + x) for x = 0 ... use
    x = 0: every hidden unit is gelu(1); W2 = I/C so y = mean of the kept,
    rescaled hidden units. E[y] = gelu(1) on the hidden mask and the output
    mask scales by 256/t on keep: E[output] stays gelu(1)."""
    C, t = 64, 230
    N = 4096
    x = torch.zeros(N, C)
    w1, b1 = torch.eye(C), torch.ones(C)
    w2, b2 = torch.eye(C), torch.zeros(C)
    y = fused_mlp(x, w1, b1, w2, b2, seed=7, drop_rate=0.1, exact_gelu=True)
    g1 = 0.5 * (1 + math.erf(1 / math.sqrt(2)))
    p = t / 256
    n = N * C
    kept = (y != 0).float().mean().item()
    assert abs(kept - p * p) < _four_sigma(p * p, n)
    # each output element is g1 * (256/t)^2 with prob p^2, else 0
    sd = g1 * (256 / t) ** 2 * math.sqrt(p * p * (1 - p * p))
    assert abs(y.mean().item() - g1) < 4 * sd / math.sqrt(n)


def test_dropout_modules_statistics():
    g = torch.Generator().manual_seed(0)
    qd = QuantizedDropout(0.1)
    x = torch.ones(128, 512)
    y = qd(x, deterministic=False, generator=g)
    p = 230 / 256
    assert abs((y > 0).float().mean().item() - p) < _four_sigma(p, x.numel())
    assert torch.equal(qd(x, deterministic=True, generator=g), x)
    dp = DropPath(0.25)
    xb = torch.ones(4000, 2, 2, 3, dtype=torch.bfloat16)
    yb = dp(xb, deterministic=False, generator=g)
    assert yb.dtype == torch.bfloat16
    per_sample = yb.reshape(4000, -1)
    assert bool(((per_sample == 0).all(1) | (per_sample != 0).all(1)).all())
    kept = (per_sample[:, 0] != 0).float().mean().item()
    assert abs(kept - 0.75) < _four_sigma(0.75, 4000)
    assert torch.allclose(per_sample[per_sample[:, 0] != 0].float(),
                          torch.tensor(1 / 0.75), rtol=1e-2)


# ------------------------------------------------------------ import hygiene

_ALLOWED_ROOTS = {"torch", "numpy", "scipy", "einops"}


def _port_files():
    files = sorted((REPO / "spherical_dyffusion_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_only_stdlib_torch_numpy_scipy_einops():
    """Every module of the port and chip_smoke.py may import only the
    standard library, torch, numpy, scipy, einops and the port itself: the
    card's machine has no jax, flax, optax, yaml or h5py."""
    files = _port_files()
    assert len(files) > 10
    scripts = {p.name for p in files if p.parent.name == "scripts"}
    assert {"skill_proof.py", "ace_skill.py", "skill_report.py"} <= scripts, scripts
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level > 0:
                    continue
                roots = [node.module.split(".")[0]]
            else:
                continue
            for root in roots:
                ok = (root in sys.stdlib_module_names or root in _ALLOWED_ROOTS
                      or root == "spherical_dyffusion_tpu_torch")
                if not ok:
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} imports {root}")
    assert not bad, "\n".join(bad)


def test_package_data_ships_every_kernel_source_and_header():
    """An installed port builds its kernels from the files under ``csrc/``:
    every source there and every file a source includes with quotes must be
    matched by the port's package data in ``pyproject.toml``."""
    import fnmatch
    import re
    import tomllib

    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    patterns = cfg["tool"]["setuptools"]["package-data"]["spherical_dyffusion_tpu_torch"]
    pkg = REPO / "spherical_dyffusion_tpu_torch"
    sources = sorted((pkg / "csrc").glob("*.cu"))
    assert sources
    needed = {p.relative_to(pkg).as_posix() for p in sources}
    for src in sources:
        for inc in re.findall(r'^\s*#include\s+"([^"]+)"', src.read_text(), re.M):
            path = (src.parent / inc).resolve()
            assert path.is_file(), f"{src.name} includes {inc}, which is not there"
            needed.add(path.relative_to(pkg.resolve()).as_posix())
    missing = [f for f in sorted(needed)
               if not any(fnmatch.fnmatch(f, pat) for pat in patterns)]
    assert not missing, f"not in the package data: {missing}"
