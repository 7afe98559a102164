"""Checkpoint-parity harness: a float64 numpy oracle of the reference SFNO
forward, and a block-by-block activation diff of the port's SFNO against it.

The oracle (``NumpySFNOOracle``, ``flip_lat_state_dict``) is a copy of the
JAX package's ``utils/parity.py``: the reference forward pass (its block,
spectral filter and time embedding) re-implemented in float64 numpy,
channels first, over a reference-format torch ``state_dict`` of numpy
arrays; it shares only the SHT matrices of ``ops/quadrature.py`` with the
port. Conventions: torch's erf GELU; InstanceNorm with the biased variance,
eps 1e-6 and affine; latitude by ascending colatitude (row 0 north), with
``flip_lat_state_dict`` for checkpoints stored the other way round.

``activation_parity_report`` runs the port's SFNO (on whatever device it
lives, the card included) and the oracle on the same input and reports the
max |diff| per block through forward hooks on the blocks and the time
embedding; ``load_reference_sfno`` builds that SFNO from a reference-format
``state_dict`` through ``utils/torch_convert.py``, as the port's reference
checkpoint loader does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.quadrature import sht_matrices

__all__ = [
    "NumpySFNOOracle",
    "activation_parity_report",
    "assert_activation_parity",
    "flip_lat_state_dict",
    "load_reference_sfno",
]


# --------------------------------------------------------------------------
# numpy primitives (float64, channels-first like the reference)
# --------------------------------------------------------------------------


def _gelu(x: np.ndarray) -> np.ndarray:
    from scipy.special import erf

    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


def _silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


def _conv1x1(x: np.ndarray, w: np.ndarray, b: Optional[np.ndarray] = None) -> np.ndarray:
    """x: (B, Ci, H, W); w: (Co, Ci, 1, 1) torch Conv2d layout."""
    y = np.einsum("bchw,oc->bohw", x, np.asarray(w, np.float64)[:, :, 0, 0])
    if b is not None:
        y = y + np.asarray(b, np.float64)[None, :, None, None]
    return y


def _linear(x: np.ndarray, w: np.ndarray, b: Optional[np.ndarray] = None) -> np.ndarray:
    """x: (B, Ci); w: (Co, Ci) torch Linear layout."""
    y = x @ np.asarray(w, np.float64).T
    if b is not None:
        y = y + np.asarray(b, np.float64)[None, :]
    return y


def _instance_norm(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                   eps: float = 1e-6) -> np.ndarray:
    """torch nn.InstanceNorm2d(affine=True, track_running_stats=False)."""
    mean = x.mean(axis=(-2, -1), keepdims=True)
    var = ((x - mean) ** 2).mean(axis=(-2, -1), keepdims=True)  # biased
    y = (x - mean) / np.sqrt(var + eps)
    return y * np.asarray(w, np.float64)[None, :, None, None] + np.asarray(
        b, np.float64)[None, :, None, None]


@dataclasses.dataclass
class _Transform:
    nlat: int
    nlon: int
    grid: str
    lmax: int
    mmax: int
    analysis: np.ndarray  # (nlat, lmax, mmax) incl. quadrature
    synthesis: np.ndarray  # (nlat, lmax, mmax)
    dft_fwd: Optional[np.ndarray] = None  # f32-rounded matmul-DFT matrices
    dft_inv: Optional[np.ndarray] = None

    @classmethod
    def create(cls, nlat, nlon, grid, lmax, mmax, round_matrices_to_f32=False):
        analysis, synthesis = sht_matrices(nlat, grid, lmax, mmax)
        dft_fwd = dft_inv = None
        if round_matrices_to_f32:
            # match the f32 rounding of the matrices frozen into our model's
            # "constants" collection (Legendre AND matmul-DFT stages), so
            # activation diffs isolate SEMANTIC mismatches instead of the
            # ~1e-7 matrix rounding that accumulates to ~1e-4 in deep stacks
            from ..ops.quadrature import dft_matrices

            analysis = analysis.astype(np.float32).astype(np.float64)
            synthesis = synthesis.astype(np.float32).astype(np.float64)
            f, i = dft_matrices(nlon, nlon // 2 + 1)
            dft_fwd = f.astype(np.float32).astype(np.float64)
            dft_inv = i.astype(np.float32).astype(np.float64)
        return cls(nlat, nlon, grid, lmax, mmax, analysis, synthesis,
                   dft_fwd, dft_inv)

    def sht(self, x: np.ndarray) -> np.ndarray:
        """(B, C, H, W) -> complex (B, C, L, M)."""
        if self.dft_fwd is not None:
            F = (np.einsum("bchw,wm->bchm", x, self.dft_fwd[..., 0])
                 + 1j * np.einsum("bchw,wm->bchm", x, self.dft_fwd[..., 1]))
        else:
            F = np.fft.rfft(x, axis=-1, norm="forward")
        F = F[..., : self.mmax]
        return np.einsum("bchm,hlm->bclm", F, self.analysis)

    def isht(self, c: np.ndarray) -> np.ndarray:
        """complex (B, C, L, M) -> (B, C, H, W)."""
        F = np.einsum("bclm,hlm->bchm", c, self.synthesis)
        mfull = self.nlon // 2 + 1
        if F.shape[-1] < mfull:
            F = np.pad(F, [(0, 0)] * (F.ndim - 1) + [(0, mfull - F.shape[-1])])
        if self.dft_inv is not None:
            return (np.einsum("bchm,mw->bchw", F.real, self.dft_inv[..., 0])
                    + np.einsum("bchm,mw->bchw", F.imag, self.dft_inv[..., 1]))
        return np.fft.irfft(F, n=self.nlon, axis=-1, norm="forward")


class NumpySFNOOracle:
    """Reference-forward oracle over a torch-format state_dict (numpy leaves).

    Config fields mirror our SFNOConfig / the reference constructor defaults
    for the released models: linear filter, dhconv or diagonal operator,
    instance norm, inner_skip=linear, outer_skip=identity, big_skip, use_mlp.
    """

    def __init__(
        self,
        state_dict: Dict[str, np.ndarray],
        img_shape: Tuple[int, int],
        num_layers: int,
        embed_dim: int,
        operator_type: str = "dhconv",
        scale_factor: int = 1,
        hard_thresholding_fraction: float = 1.0,
        encoder_layers: int = 1,
        big_skip: bool = True,
        use_mlp: bool = True,
        with_time_emb: bool = False,
        time_scale_shift_before_filter: bool = True,
        time_rescale: bool = False,
        min_time: float = 0.0,
        max_time: float = 1000.0,
        data_grid: str = "equiangular",
        round_matrices_to_f32: bool = False,
        dropout_mlp: float = 0.0,
    ):
        self.sd = {k: np.asarray(v, np.float64) for k, v in state_dict.items()}
        self.img_shape = tuple(img_shape)
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.operator_type = operator_type
        self.encoder_layers = encoder_layers
        self.big_skip = big_skip
        self.use_mlp = use_mlp
        self.with_time_emb = with_time_emb
        self.tss_before = time_scale_shift_before_filter
        self.time_rescale = time_rescale
        self.min_time, self.max_time = min_time, max_time
        self.dropout_mlp = float(dropout_mlp)

        H, W = self.img_shape
        h, w = H // scale_factor, W // scale_factor
        lmax = int(h * hard_thresholding_fraction)
        mmax = int((w // 2 + 1) * hard_thresholding_fraction)
        # the reference's four transforms (sfnonet.py:551-554)
        r32 = round_matrices_to_f32
        self.trans_down = _Transform.create(H, W, data_grid, lmax, mmax, r32)
        self.itrans_up = _Transform.create(H, W, data_grid, lmax, mmax, r32)
        self.trans = _Transform.create(h, w, "legendre-gauss", lmax, mmax, r32)
        self.itrans = _Transform.create(h, w, "legendre-gauss", lmax, mmax, r32)

    # -------------------------------------------------------------- pieces
    def _time_repr(self, time: np.ndarray) -> np.ndarray:
        """SinusoidalPosEmb -> Linear -> GELU -> Linear (misc.py:21-33,145-147)."""
        t = np.asarray(time, np.float64)
        if self.time_rescale:
            t = (t - self.min_time) * (1000.0 / (self.max_time - self.min_time))
        dim = self.embed_dim
        half = dim // 2
        freqs = np.exp(-math.log(10000.0) * np.arange(half) / (half - 1))
        args = t[:, None] * freqs[None, :]
        emb = np.concatenate([np.sin(args), np.cos(args)], axis=-1)
        emb = _linear(emb, self.sd["time_emb_mlp.1.weight"], self.sd["time_emb_mlp.1.bias"])
        emb = _gelu(emb)
        return _linear(emb, self.sd["time_emb_mlp.3.weight"], self.sd["time_emb_mlp.3.bias"])

    def _time_scale_shift(self, x: np.ndarray, t_repr: np.ndarray, i: int) -> np.ndarray:
        emb = _silu(t_repr)
        emb = _linear(emb, self.sd[f"blocks.{i}.time_mlp.1.weight"],
                      self.sd[f"blocks.{i}.time_mlp.1.bias"])
        scale, shift = np.split(emb[:, :, None, None], 2, axis=1)
        return x * (scale + 1.0) + shift

    def _filter(self, x_norm: np.ndarray, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """SpectralConvS2.forward (s2convolutions.py:158-193)."""
        first, last = i == 0, i == self.num_layers - 1
        fwd = self.trans_down if first else self.trans
        inv = self.itrans_up if last else self.itrans
        coef = fwd.sht(x_norm)
        scale_residual = (fwd.nlat != inv.nlat or fwd.nlon != inv.nlon
                          or fwd.grid != inv.grid)
        residual = inv.isht(coef) if scale_residual else x_norm
        if f"blocks.{i}.filter.w.0" in self.sd:
            # non-linear SpectralAttentionS2.forward_mlp (s2convolutions.py:
            # 384-436): complex MLP per spectral mode, ComplexReLU mode
            # "real" between layers (relu on the real part, identity imag,
            # activations.py:57-61), final wout contraction
            # per-layer complex contraction: shared weights (ci, co, 2) via
            # compl_mul2d_fwd, or per-degree (l, ci, co, 2) via
            # compl_exp_mul2d_fwd (operator_type "l-dependant",
            # s2convolutions.py:352-378)
            def _cmul(z, wgt):
                wc = wgt[..., 0] + 1j * wgt[..., 1]
                if wgt.ndim == 4:
                    return np.einsum("bilm,lio->bolm", z, wc)
                return np.einsum("bilm,io->bolm", z, wc)

            z = coef
            li = 0
            while f"blocks.{i}.filter.w.{li}" in self.sd:
                z = _cmul(z, self.sd[f"blocks.{i}.filter.w.{li}"])
                bkey = f"blocks.{i}.filter.b.{li}"
                if bkey in self.sd:
                    b = self.sd[bkey]  # (co, 1, 1, 2)
                    z = z + (b[..., 0] + 1j * b[..., 1])[None]
                z = np.maximum(z.real, 0.0) + 1j * z.imag
                li += 1
            out = _cmul(z, self.sd[f"blocks.{i}.filter.wout"])
            return inv.isht(out), residual
        wgt = self.sd[f"blocks.{i}.filter.filter.weight"]  # (ci, co, l[, m], 2)
        wc = wgt[..., 0] + 1j * wgt[..., 1]
        if self.operator_type == "dhconv":
            out = np.einsum("bilm,iol->bolm", coef, wc)
        elif self.operator_type == "diagonal":
            out = np.einsum("bilm,iolm->bolm", coef, wc)
        else:
            raise ValueError(self.operator_type)
        y = inv.isht(out)
        bkey = f"blocks.{i}.filter.filter.bias"
        if bkey in self.sd:
            y = y + self.sd[bkey].reshape(1, -1, 1, 1)
        return y, residual

    def _dropout(self, x: np.ndarray,
                 rng: Optional[np.random.Generator]) -> np.ndarray:
        """Inverted float-bernoulli dropout at the exact rate — the reference
        torch ``nn.Dropout`` semantics (train mode). Active only when the
        caller passes an rng; parity's deterministic legs pass None."""
        p = self.dropout_mlp
        if rng is None or p <= 0.0:
            return x
        keep = rng.random(x.shape) >= p
        return x * keep / (1.0 - p)

    def _block(self, x: np.ndarray, i: int, t_repr: Optional[np.ndarray],
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """FourierNeuralOperatorBlock.forward (sfnonet.py:289-337)."""
        sd = self.sd
        x_norm = _instance_norm(x, sd[f"blocks.{i}.norm0.weight"],
                                sd[f"blocks.{i}.norm0.bias"])
        if t_repr is not None and self.tss_before:
            x_norm = self._time_scale_shift(x_norm, t_repr, i)
        y, residual = self._filter(x_norm, i)
        y = y + _conv1x1(residual, sd[f"blocks.{i}.inner_skip.weight"],
                         sd[f"blocks.{i}.inner_skip.bias"])
        # act_layer exists only for the linear filter family
        # (sfnonet.py:248-249, applied :310-311)
        if f"blocks.{i}.filter.w.0" not in sd:
            y = _gelu(y)
        y = _instance_norm(y, sd[f"blocks.{i}.norm1.weight"],
                           sd[f"blocks.{i}.norm1.bias"])
        if t_repr is not None and not self.tss_before:
            y = self._time_scale_shift(y, t_repr, i)
        if self.use_mlp:
            fc2 = 3 if f"blocks.{i}.mlp.fwd.3.weight" in sd else 2
            y = _conv1x1(y, sd[f"blocks.{i}.mlp.fwd.0.weight"],
                         sd[f"blocks.{i}.mlp.fwd.0.bias"])
            y = _gelu(y)
            # reference MLP Sequential: fc1, act, drop, fc2, drop
            # (modulus layers.py MLP; active only in train mode / with rng)
            y = self._dropout(y, rng)
            y = _conv1x1(y, sd[f"blocks.{i}.mlp.fwd.{fc2}.weight"],
                         sd[f"blocks.{i}.mlp.fwd.{fc2}.bias"])
            y = self._dropout(y, rng)
        return y + residual

    # -------------------------------------------------------------- forward
    def forward(
        self,
        inputs: np.ndarray,  # (B, C, H, W)
        time: Optional[np.ndarray] = None,
        condition: Optional[np.ndarray] = None,
        static_condition: Optional[np.ndarray] = None,
        collect: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Reference SFNO forward (sfnonet.py:797-837). Returns (output,
        per-stage activations keyed encoder/pos/block_i/decoder). ``rng``
        activates train-mode MLP dropout (the stochastic-parity leg)."""
        sd = self.sd
        acts: Dict[str, np.ndarray] = {}
        parts = [np.asarray(inputs, np.float64)]
        for c in (condition, static_condition):
            if c is not None:
                parts.append(np.asarray(c, np.float64))
        x = np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
        residual = x if self.big_skip else None

        for i in range(self.encoder_layers):
            x = _conv1x1(x, sd[f"encoder.{2 * i}.weight"], sd[f"encoder.{2 * i}.bias"])
            x = _gelu(x)
        x = _conv1x1(x, sd[f"encoder.{2 * self.encoder_layers}.weight"])
        if collect:
            acts["encoder"] = x.copy()

        if "pos_embed" in sd:
            x = x + sd["pos_embed"]
            if collect:
                acts["pos"] = x.copy()

        t_repr = self._time_repr(time) if (self.with_time_emb and time is not None) else None
        if t_repr is not None and collect:
            acts["time_emb"] = t_repr.copy()

        for i in range(self.num_layers):
            x = self._block(x, i, t_repr, rng=rng)
            if collect:
                acts[f"block_{i}"] = x.copy()

        if self.big_skip:
            x = np.concatenate([x, residual], axis=1)
        for i in range(self.encoder_layers):
            x = _conv1x1(x, sd[f"decoder.{2 * i}.weight"], sd[f"decoder.{2 * i}.bias"])
            x = _gelu(x)
        x = _conv1x1(x, sd[f"decoder.{2 * self.encoder_layers}.weight"])
        if collect:
            acts["decoder"] = x.copy()
        return x, acts


# --------------------------------------------------------------------------
# the diff harness
# --------------------------------------------------------------------------


def flip_lat_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Flip every latitude-indexed weight (currently pos_embed (1, C, H, W))
    for checkpoints whose training data was stored with the opposite latitude
    orientation; flip the input/output H axis correspondingly at call sites."""
    out = dict(sd)
    if "pos_embed" in out:
        out["pos_embed"] = np.ascontiguousarray(out["pos_embed"][:, :, ::-1, :])
    return out


def load_reference_sfno(state_dict: Dict[str, Any], img_shape: Tuple[int, int],
                        device=None, **model_cfg):
    """The port's SFNO with a reference-format torch ``state_dict`` loaded:
    the architecture read from the weights
    (``utils/torch_convert.py:infer_sfno_architecture``), the weights mapped
    through the flax names (``sfno_torch_to_flax``), exact erf gelu, norm and
    dropout as the reference checkpoint loader builds it; ``model_cfg``
    adds ``SFNOConfig`` fields (``min_time``, ``max_time``, ``use_pallas``,
    ``fused_tail``, ...). Built on ``device`` (the card unless told)."""
    from ..interface import resolve_device
    from ..models.sfno import SFNO, SFNOConfig
    from .convert import flax_to_state_dict
    from .torch_convert import infer_sfno_architecture, sfno_torch_to_flax

    sd = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in state_dict.items()}
    arch = infer_sfno_architecture(sd)
    kw = dict(activation_function="gelu_exact", exact_norm=True, exact_dropout=True)
    kw.update(model_cfg)
    cfg = SFNOConfig(img_shape=tuple(img_shape), in_chans=arch["net_in_chans"],
                     out_chans=arch["net_out_chans"], with_time_emb=arch["with_time_emb"],
                     **{k: arch[k] for k in ("embed_dim", "num_layers", "encoder_layers",
                                             "operator_type", "pos_embed", "use_mlp",
                                             "mlp_ratio", "filter_type", "spectral_layers")},
                     **kw)
    device = torch.device(device) if device is not None else resolve_device({})
    model = SFNO(cfg).to(device)
    model.load_state_dict(flax_to_state_dict(sfno_torch_to_flax(
        sd, arch["num_layers"], arch["encoder_layers"])))
    return model.eval()


def activation_parity_report(
    model: torch.nn.Module,
    oracle: NumpySFNOOracle,
    inputs_bhwc: np.ndarray,
    time: Optional[np.ndarray] = None,
    condition_bhwc: Optional[np.ndarray] = None,
    reference: Optional[Tuple[np.ndarray, Dict[str, np.ndarray]]] = None,
) -> Dict[str, Dict[str, float]]:
    """Run the port's SFNO (channels last, on its own device, without
    gradients) and the oracle on the same float32 input; return per block
    (and for the time embedding and the output) ``max_abs`` |port -
    oracle|, the oracle's largest |value| as ``scale`` and their ratio
    ``rel``. The blocks' outputs are read by forward hooks on ``block_i``
    and ``time_emb``. ``reference``, the oracle's ``forward`` of the same
    input computed earlier (say in another process), stands in for running
    it here."""
    dev = next(model.parameters()).device
    captured: Dict[str, torch.Tensor] = {}
    hooks = []
    for i in range(oracle.num_layers):
        hooks.append(getattr(model, f"block_{i}").register_forward_hook(
            lambda _m, _a, out, i=i: captured.__setitem__(f"block_{i}", out.detach())))
    if getattr(model, "time_emb", None) is not None:
        hooks.append(model.time_emb.register_forward_hook(
            lambda _m, _a, out: captured.__setitem__("time_emb", out.detach())))
    kwargs = {}
    if time is not None:
        kwargs["time"] = torch.as_tensor(np.asarray(time, np.float32), device=dev)
    if condition_bhwc is not None:
        kwargs["condition"] = torch.as_tensor(np.asarray(condition_bhwc, np.float32),
                                              device=dev)
    try:
        with torch.no_grad():
            out = model(torch.as_tensor(np.asarray(inputs_bhwc, np.float32), device=dev),
                        **kwargs)
    finally:
        for h in hooks:
            h.remove()

    def chf(a: torch.Tensor) -> np.ndarray:  # (B, H, W, C) -> (B, C, H, W)
        return np.moveaxis(a.float().cpu().numpy().astype(np.float64), -1, 1)

    if reference is None:
        cond_bchw = (np.moveaxis(condition_bhwc, -1, 1)
                     if condition_bhwc is not None else None)
        reference = oracle.forward(np.moveaxis(inputs_bhwc, -1, 1), time=time,
                                   condition=cond_bchw)
    ref_out, ref_acts = reference

    def entry(got, ref):
        scale = float(np.max(np.abs(ref)) + 1e-30)
        diff = float(np.max(np.abs(got - ref)))
        return {"max_abs": diff, "scale": scale, "rel": diff / scale}

    report: Dict[str, Dict[str, float]] = {}
    for i in range(oracle.num_layers):
        report[f"block_{i}"] = entry(chf(captured[f"block_{i}"]), ref_acts[f"block_{i}"])
    if "time_emb" in ref_acts:
        got_t = captured["time_emb"].float().cpu().numpy().astype(np.float64)
        report["time_emb"] = entry(got_t, ref_acts["time_emb"])
    report["output"] = entry(chf(out), ref_out)
    return report


def assert_activation_parity(report: Dict[str, Dict[str, float]],
                             rtol: float = 2e-5, atol: float = 1e-6) -> None:
    """Each stage's max |port - oracle| must be at most ``atol + rtol *
    scale``: the oracle runs in float64, the port in float32, so the floor
    is float32 accumulation noise relative to the activation's magnitude; a
    conversion or semantics fault (a transposed kernel, a wrong norm, a
    flipped latitude) shows as rel >= 1e-2."""
    bad = {k: v for k, v in report.items() if v["max_abs"] > atol + rtol * v["scale"]}
    if bad:
        raise AssertionError(
            f"activation parity violated (rtol={rtol}, atol={atol}): "
            + ", ".join(f"{k}: max_abs={v['max_abs']:.2e} rel={v['rel']:.2e}"
                        for k, v in sorted(bad.items())))
