"""Snapshot panels and zonal-mean Hovmoeller images as PNG files.

Counterpart of ``spherical_dyffusion_tpu/evaluation/plots.py`` without
matplotlib (the card's machine has none, and the port imports only the
standard library, torch, numpy, scipy and einops). The files, their names and
the colour mapping are JAX's:

* ``plot_snapshot_panels`` writes ``snapshot_t{step}.png``: one row per
  variable (the first ``max_vars``), the columns prediction, target and
  error (prediction - target);
* ``plot_zonal_mean_hovmoeller`` writes ``zonal_mean_{name}.png``: the
  prediction's, the target's and the error's (H, T) zonal means side by
  side;
* the first two panels of a row map through viridis between the target's
  2nd and 98th percentiles, the error through ``RdBu_r`` between its own
  minimum and maximum (matplotlib's autoscale); a value maps to a colour as
  matplotlib's ``Normalize`` and ``Colormap.__call__`` do (``x * 256``
  truncated, below the range the first colour, above it the last, NaN
  transparent), through the two colormaps' 256-entry tables held below as
  literals (``matplotlib.colormaps[name](range(256), bytes=True)``).

What differs from JAX's figures: no titles, ticks, labels or colorbars (there
is no font renderer), and one pixel per grid point, the panels abutting, in
place of matplotlib's resampled axes at 90 dpi. The PNGs are 8-bit RGBA,
written with ``zlib`` and ``struct``; ``read_png`` reads them back.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Sequence

import numpy as np

__all__ = ["plot_snapshot_panels", "plot_zonal_mean_hovmoeller", "colorize", "write_png",
           "read_png"]

# the RGB bytes of matplotlib's 256-entry tables (alpha 255 throughout)
_VIRIDIS = bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f624711634712654714664715"
    "6747166947186a48196b481a6c481c6e481d6f481e7048207148217248227348237447257547267647277747"
    "2878472a79472b7a472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83"
    "433b83433c84423d84423e854240854141864142864043874044873f45873f47883e48883e49893d4a893d4b"
    "893d4c893c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c36"
    "5b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d31668d30678d30688d2f698d"
    "2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e2c728e2b738e2b748e2a758e2a768e2a778e2978"
    "8e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24"
    "868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e881e9f881ea0871fa1"
    "871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad8028ae7f29"
    "af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7"
    "645bc8625ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517c"
    "d24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938"
    "a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e0"
    "1fcae01ecde01dcfe11cd2e11bd4e11ad7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aee"
    "e51bf1e51cf3e51ef6e61ff8e621fae622fde724"
)
_RDBU_R = bytes.fromhex(
    "05306106326307346608366909386c0a3a6f0b3c720c3e750d40780e437b0f457e114781124984134b87144d"
    "8a154f8d1651901754931856951958981a5a9b1c5c9e1d5ea11e60a41f62a72064aa2166ac2368ad246aae25"
    "6caf276db0286fb02971b12b73b22c75b32d76b42f78b5307ab6317cb7337db8347fb93581b93783ba3884bb"
    "3986bc3b88bd3c8abe3d8bbf3f8dc0408fc14191c24393c34694c44996c54c98c64f9ac7529cc8559ec958a0"
    "ca5ba2cb5ea4cc61a6cd65a8ce68aacf6bacd06eaed171b0d274b2d377b4d57ab6d67db8d780bad884bcd987"
    "beda8ac0db8dc2dc90c4dd93c5de95c6df98c8df9ac9e09dcae19fcbe1a2cde2a4cee3a7cfe4a9d0e4abd2e5"
    "aed3e6b0d4e6b3d5e7b5d7e8b8d8e8bad9e9bddaeabfdcebc2ddebc4deecc7dfedc9e1edcce2eecee3efd1e5"
    "f0d2e5f0d3e6f0d5e7f0d6e7f1d8e8f1d9e9f1dbe9f1dceaf2deebf2dfecf2e1ecf3e2edf3e4eef3e5eef3e7"
    "eff4e8f0f4eaf1f4ebf1f4edf2f5eef3f5f0f3f5f1f4f6f3f5f6f4f5f6f6f6f6f7f6f6f7f5f4f7f4f2f7f3f0"
    "f8f2eef8f0ecf8efeaf8eee8f9ede7f9ece5f9ebe3f9eae1f9e9dffae8ddfae7dbfae5d9fae4d7fbe3d6fbe2"
    "d4fbe1d2fbe0d0fcdfcefcdeccfcddcafcdcc8fddbc7fcd8c4fcd6c1fbd4befbd2bcfbd0b9faceb6faccb4fa"
    "cab1f9c7aef9c5abf9c3a9f8c1a6f8bfa3f8bda1f7bb9ef7b99bf7b799f6b496f6b293f5b090f5ae8ef5ac8b"
    "f4aa88f4a886f4a683f3a380f2a07ef19e7cef9b7aee9878ed9676ec9374eb9072ea8e70e88b6ee7886ce685"
    "6ae58368e48065e27d63e17b61e0785fdf755dde725bdd7059db6d57da6a55d96853d86551d7624fd6604dd4"
    "5d4bd35a4ad15749d05447ce5146cd4f45cc4c43ca4942c94641c7433fc6403ec53e3cc33b3bc2383ac03538"
    "bf3237be3036bc2d34bb2a33b92732b82431b6212fb51f2eb41c2db2192bb0172aad162aaa1529a71429a413"
    "28a112289e11279b1027991027960f26930e26900d258d0c258a0b24870a248409238108237e07227b062278"
    "05217504217203206f02206c011f69001f67001f"
)

_LUTS = {"viridis": _VIRIDIS, "RdBu_r": _RDBU_R}
_N = 256
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _lut(name: str) -> np.ndarray:
    """(N + 3, 4) uint8: the N colours, then under (the first), over (the
    last) and bad (transparent black), in matplotlib's order."""
    rgb = np.frombuffer(_LUTS[name], np.uint8).reshape(_N, 3)
    lut = np.zeros((_N + 3, 4), np.uint8)
    lut[:_N, :3], lut[:_N, 3] = rgb, 255
    lut[_N], lut[_N + 1] = lut[0], lut[_N - 1]
    return lut


def colorize(field: np.ndarray, vmin: float, vmax: float, cmap: str) -> np.ndarray:
    """(..., 4) uint8 RGBA of ``field`` (as float64) normalized to [vmin,
    vmax] and mapped through ``cmap``, as matplotlib's ``Normalize`` and
    ``Colormap.__call__(..., bytes=True)`` map it."""
    x = np.array(field, np.float64)
    if vmin == vmax:
        x.fill(0.0)
    elif vmin > vmax:
        raise ValueError("minvalue must be less than or equal to maxvalue")
    else:
        x -= vmin
        x /= (vmax - vmin)
    x *= _N
    x[x == _N] = _N - 1
    under, over, bad = x < 0, x >= _N, np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    idx[under], idx[over], idx[bad] = _N, _N + 1, _N + 2
    return _lut(cmap).take(idx, axis=0, mode="clip")


def write_png(path: str, rgba: np.ndarray) -> None:
    """An (H, W, 4) uint8 array as an 8-bit RGBA PNG (no interlacing, each
    row with filter 0), written under a temporary name and renamed."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, c = rgba.shape
    if c != 4:
        raise ValueError(f"write_png takes (H, W, 4) RGBA, got {rgba.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, 4 * w)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    png = (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)


def read_png(path: str) -> np.ndarray:
    """The (H, W, 4) uint8 pixels of an 8-bit RGBA, non-interlaced PNG whose
    rows use filter 0, as ``write_png`` writes them; raises
    ``NotImplementedError`` on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, color, _, _, interlace = head
    if (depth, color, interlace) != (8, 6, 0):
        raise NotImplementedError(f"{path}: bit depth {depth}, colour type {color}, "
                                  f"interlace {interlace}; only 8-bit RGBA is read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 4 * w)
    if raw[:, 0].any():
        raise NotImplementedError(f"{path}: rows with filters other than 0")
    return raw[:, 1:].reshape(h, w, 4).copy()


def _row(p: np.ndarray, t: np.ndarray) -> np.ndarray:
    """prediction | target | error of one variable, side by side."""
    vmin, vmax = np.percentile(t, [2, 98])
    err = p - t
    return np.concatenate([colorize(p, vmin, vmax, "viridis"),
                           colorize(t, vmin, vmax, "viridis"),
                           colorize(err, np.nanmin(err), np.nanmax(err), "RdBu_r")], axis=1)


def plot_snapshot_panels(snapshots: Dict[int, dict], names: Sequence[str], out_dir: str,
                         max_vars: int = 4) -> Dict[int, str]:
    """Per snapshot step, the (prediction | target | error) rows of the
    first ``max_vars`` variables (``snapshots[step]["preds"]`` and
    ``["targets"]``, (H, W, C)) as ``out_dir/snapshot_t{step}.png``;
    returns ``{step: path}``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for step, snap in snapshots.items():
        preds = np.asarray(snap["preds"], np.float64)
        targets = np.asarray(snap["targets"], np.float64)
        n = min(max_vars, preds.shape[-1], len(names))
        img = np.concatenate([_row(preds[..., i], targets[..., i]) for i in range(n)], axis=0)
        path = os.path.join(out_dir, f"snapshot_t{step}.png")
        write_png(path, img)
        paths[step] = path
    return paths


def plot_zonal_mean_hovmoeller(pred_zonal: np.ndarray, tgt_zonal: np.ndarray,
                               names: Sequence[str], out_dir: str,
                               max_vars: int = 4) -> Dict[str, str]:
    """The (latitude, time) zonal means of prediction, target and error
    (``pred_zonal`` and ``tgt_zonal`` (T, H, C)) of the first ``max_vars``
    variables, one ``out_dir/zonal_mean_{name}.png`` each; returns
    ``{name: path}``."""
    os.makedirs(out_dir, exist_ok=True)
    pred_zonal = np.asarray(pred_zonal, np.float64)
    tgt_zonal = np.asarray(tgt_zonal, np.float64)
    paths = {}
    for i, name in enumerate(list(names)[:max_vars]):
        img = _row(pred_zonal[..., i].T, tgt_zonal[..., i].T)  # (H, T) panels
        path = os.path.join(out_dir, f"zonal_mean_{name}.png")
        write_png(path, img)
        paths[name] = path
    return paths
