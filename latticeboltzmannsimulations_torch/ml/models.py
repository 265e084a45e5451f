"""Encoder-decoder CNN family: the JAX package's flax ``CavityCNN`` and its
ten presets (the reference's Keras surrogates ``CNN_One`` ... ``CNN_Ten``)
as a ``torch.nn.Module``.

The public layout stays the JAX package's NHWC: ``x (B, H, W, C_in)`` and
``aux (B, H, W, 2)`` in, ``(B, H, W, 1)`` out; inside, the module runs
NCHW.  Each layer is named as its flax counterpart (``ms2``, ``enc0``,
``dec_a_deconv0``, ``head1``, ...), so ``state_dict_from_flax`` carries the
JAX package's parameters across name for name.

What the conversion has to get right, each pinned by a test against flax:

* a flax ``Conv`` kernel is HWIO, torch's OIHW;
* flax's ``ConvTranspose`` (``transpose_kernel=False``) is a convolution of
  the stride-dilated input with the kernel as it is, while torch's
  ``conv_transpose2d`` flips the kernel and stores it (in, out, kh, kw): so
  the kernel is flipped in space and its in and out swapped;
* ``padding="SAME"`` pads ``max((ceil(n/s) - 1) s + k - n, 0)`` in all,
  ``total // 2`` on the low side: asymmetric for an odd total, so the
  convolutions pad explicitly; the transposed ``SAME`` of
  ``lax.conv_transpose`` pads the dilated input by
  ``(k - 1, s - 1)`` when ``s > k - 1``, else by
  ``(ceil((k+s-2)/2), floor((k+s-2)/2))``, which here crops or pads
  ``conv_transpose2d``'s full output.

Precision: float32 convolutions run without TF32 unless the module is built
with ``allow_tf32=True`` (cuDNN would take TF32 by default), as the JAX
package's ``compute_dtype`` states the precision of its convolutions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CNNPreset:
    name: str
    resolution: int                       # native training grid
    encoder: Tuple[Tuple[int, int, int], ...]   # (features, kernel, stride)
    decoder: Tuple[Tuple[int, int, int], ...]   # (features, kernel, stride)
    twin_decoders: bool = True
    multiscale_front: Optional[Tuple[int, ...]] = None
    aux_bc_at_input: bool = False
    aux_bc_at_head: bool = False
    activation: str = "relu"              # 'relu' | 'leaky_relu'
    optimizer: str = "rmsprop"            # 'rmsprop' | 'adam'
    # input scaling mode (the M4-M6 deltas): 'max' = divide by per-array max
    # (CNN_One..Three), 'minmax' = MinMaxScaler to scale_range (CNN_Four+)
    scaling: str = "max"
    scale_range: Tuple[float, float] = (0.2, 0.7)
    epochs: int = 500
    batch_size: int = 5


# Encoder/decoder shapes follow each reference variant's stride pyramid; the
# same ten presets, field for field, as the JAX package's.
PRESETS = {
    "cnn_one": CNNPreset(
        name="cnn_one", resolution=192,
        encoder=((128, 12, 12), (256, 4, 4), (512, 4, 1)),
        decoder=((256, 4, 1), (128, 4, 4), (64, 12, 12)),
        epochs=500, batch_size=5,
    ),
    "cnn_two": CNNPreset(
        name="cnn_two", resolution=192,
        encoder=((64, 4, 4), (128, 4, 4), (256, 4, 3), (512, 4, 1)),
        decoder=((256, 4, 1), (128, 4, 3), (64, 4, 4), (32, 4, 4)),
        epochs=500, batch_size=5,
    ),
    "cnn_three": CNNPreset(
        name="cnn_three", resolution=192,
        encoder=((64, 4, 4), (128, 4, 4), (256, 3, 3), (512, 2, 2)),
        decoder=((256, 2, 2), (128, 3, 3), (64, 4, 4), (32, 4, 4)),
        epochs=500, batch_size=5,
    ),
    "cnn_four": CNNPreset(
        name="cnn_four", resolution=192,
        encoder=((64, 4, 4), (128, 4, 4), (256, 3, 3), (512, 2, 2)),
        decoder=((256, 2, 2), (128, 3, 3), (64, 4, 4), (32, 4, 4)),
        scaling="minmax", scale_range=(0.0, 1.0),
        epochs=500, batch_size=20,
    ),
    "cnn_five": CNNPreset(
        name="cnn_five", resolution=192,
        encoder=((64, 4, 4), (128, 4, 4), (256, 3, 3), (512, 2, 2)),
        decoder=((256, 2, 2), (128, 3, 3), (64, 4, 4), (32, 4, 4)),
        scaling="minmax", scale_range=(0.2, 0.7),
        epochs=500, batch_size=20,
    ),
    "cnn_six": CNNPreset(
        name="cnn_six", resolution=192,
        encoder=((64, 4, 4), (128, 4, 4), (256, 3, 3), (512, 2, 2)),
        decoder=((256, 2, 2), (128, 3, 3), (64, 4, 4), (32, 4, 4)),
        scaling="minmax_all", scale_range=(0.2, 0.7),
        epochs=200, batch_size=20,
    ),
    "cnn_seven": CNNPreset(
        name="cnn_seven", resolution=384,
        encoder=((16, 2, 2), (64, 4, 4), (128, 4, 4), (256, 3, 3), (512, 2, 2)),
        decoder=((256, 2, 2), (128, 3, 3), (64, 4, 4), (32, 4, 4), (16, 2, 2)),
        scaling="minmax_all", scale_range=(0.2, 0.7),
        epochs=200, batch_size=20,
    ),
    "cnn_eight": CNNPreset(
        name="cnn_eight", resolution=384,
        encoder=((16, 2, 2), (64, 4, 4), (128, 4, 4), (256, 3, 3), (512, 2, 2)),
        decoder=((256, 2, 2), (128, 3, 3), (64, 4, 4), (32, 4, 4), (16, 2, 2)),
        aux_bc_at_head=True,
        scaling="minmax_all", scale_range=(0.2, 0.7),
        epochs=600, batch_size=20,
    ),
    "cnn_nine": CNNPreset(
        name="cnn_nine", resolution=384,
        encoder=((16, 2, 2), (64, 4, 4), (128, 4, 4), (256, 3, 3), (512, 2, 2)),
        decoder=((256, 2, 2), (128, 3, 3), (64, 4, 4), (32, 4, 4), (16, 2, 2)),
        multiscale_front=(2, 4, 8, 12),
        aux_bc_at_input=True, aux_bc_at_head=True,
        scaling="minmax_all", scale_range=(0.2, 0.7),
        epochs=350, batch_size=20,
    ),
    "cnn_ten": CNNPreset(
        name="cnn_ten", resolution=384,
        encoder=((16, 2, 2), (64, 4, 4), (128, 4, 4), (256, 3, 3), (512, 2, 2)),
        decoder=((256, 2, 2), (128, 3, 3), (64, 4, 4), (32, 4, 4), (16, 2, 2)),
        twin_decoders=False,
        multiscale_front=(2, 4, 8, 12),
        aux_bc_at_input=True, aux_bc_at_head=True,
        activation="leaky_relu", optimizer="adam",
        scaling="minmax_all", scale_range=(0.2, 0.7),
        epochs=400, batch_size=20,
    ),
}


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """``(low, high)`` padding of a ``SAME`` convolution along one axis of
    ``n`` cells, kernel ``k``, stride ``s`` (XLA's rule)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def same_transpose_padding(k: int, s: int) -> tuple[int, int]:
    """``(low, high)`` padding of the stride-dilated input of a ``SAME``
    transposed convolution (``lax.conv_transpose``'s rule)."""
    pad_len = k + s - 2
    low = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    return low, pad_len - low


class _Conv(nn.Module):
    """A ``SAME`` convolution, weight OIHW."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int = 1):
        super().__init__()
        self.k, self.s, self.fans = k, s, (k * k * c_in, k * k * c_out)
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h, w = x.shape[-2:]
        (t, b), (le, r) = (same_padding(h, self.k, self.s),
                           same_padding(w, self.k, self.s))
        x = F.pad(x.to(dtype), (le, r, t, b))
        return F.conv2d(x, self.weight.to(dtype), self.bias.to(dtype), stride=self.s)


class _ConvTranspose(nn.Module):
    """A ``SAME`` transposed convolution as flax computes it (the kernel
    not flipped), on ``conv_transpose2d``: weight (in, out, kh, kw), the
    flax kernel flipped in space; the full output cropped (or padded) to the
    ``SAME`` window."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int):
        super().__init__()
        self.k, self.s, self.fans = k, s, (k * k * c_in, k * k * c_out)
        self.weight = nn.Parameter(torch.empty(c_in, c_out, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.conv_transpose2d(x.to(dtype), self.weight.to(dtype), stride=self.s)
        # conv_transpose2d's output is the dilated input padded by k - 1 on
        # both sides; SAME pads it by (low, high) instead.  The bias goes on
        # after the crop or pad, so a padded border gets it too.
        low, high = same_transpose_padding(self.k, self.s)
        d_lo, d_hi = low - (self.k - 1), high - (self.k - 1)
        y = F.pad(y, (d_lo, d_hi, d_lo, d_hi))
        return y + self.bias.to(dtype)[:, None, None]


@contextlib.contextmanager
def _cudnn_tf32(allow: bool):
    """cuDNN's TF32 switch for float32 convolutions, set for the block and
    restored after it."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def input_channels(preset: CNNPreset) -> int:
    """9 feq planes + 1 Re plane (+2 aux planes when joined at the input)."""
    return 10 + (2 if preset.aux_bc_at_input else 0)


def _uses_aux(preset: CNNPreset) -> bool:
    return preset.aux_bc_at_input or preset.aux_bc_at_head


class CavityCNN(nn.Module):
    """Encoder-decoder surrogate: (feq planes + Re plane [+ BC planes]) ->
    one steady-state velocity-component field.

    ``forward(x, aux=None)`` takes NHWC ``x (B, H, W, C_in)`` and, for the
    presets that join the lid-BC velocity planes, ``aux (B, H, W, 2)``
    (reference ``CNNEight_384/CNN_Eight.py:23-25``); it returns
    ``(B, H, W, 1)`` in float32.  ``compute_dtype`` is the type of every
    layer but ``head1`` (float32 whatever it is); ``kernel_init`` is the
    weight initialisation ('lecun_normal' or 'glorot_uniform', bias zeros),
    drawn from ``seed``.
    """

    def __init__(self, preset: CNNPreset, compute_dtype: torch.dtype = torch.float32,
                 kernel_init: str = "lecun_normal", allow_tf32: bool = False,
                 seed: int = 0):
        super().__init__()
        self.preset = preset
        self.compute_dtype = compute_dtype
        self.allow_tf32 = allow_tf32
        p = preset
        c_in = input_channels(p)
        c = c_in
        if p.multiscale_front:
            for k in p.multiscale_front:
                setattr(self, f"ms{k}", _Conv(c_in, 8, k))
            c = 8 * len(p.multiscale_front)
        for i, (feat, k, s) in enumerate(p.encoder):
            setattr(self, f"enc{i}", _Conv(c, feat, k, s))
            c = feat
        z = c
        branches = ("dec_a", "dec_b") if p.twin_decoders else ("dec",)
        for name in branches:
            c = z
            for i, (feat, k, s) in enumerate(p.decoder):
                setattr(self, f"{name}_deconv{i}", _ConvTranspose(c, feat, k, s))
                c = feat
        self.branches = branches
        head_in = len(branches) * c + c_in + (2 if p.aux_bc_at_head else 0)
        self.head0 = _Conv(head_in, 16, 1)
        self.head1 = _Conv(16, 1, 1)
        self.reset_parameters(kernel_init, seed)

    def reset_parameters(self, kernel_init: str = "lecun_normal", seed: int = 0) -> None:
        """Weights drawn from ``seed`` (flax's initialisers: LeCun normal,
        truncated at two deviations, or Glorot uniform), biases zero."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in self.modules():
                if not isinstance(layer, (_Conv, _ConvTranspose)):
                    continue
                w = layer.weight
                fan_in, fan_out = layer.fans
                if kernel_init == "lecun_normal":
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    w.copy_(torch.nn.init.trunc_normal_(
                        torch.empty(w.shape), std=std, a=-2 * std, b=2 * std,
                        generator=gen))
                elif kernel_init == "glorot_uniform":
                    lim = math.sqrt(6.0 / (fan_in + fan_out))
                    w.copy_(torch.empty(w.shape).uniform_(-lim, lim, generator=gen))
                else:
                    raise ValueError(f"unknown kernel_init {kernel_init!r}")
                layer.bias.zero_()

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if self.preset.activation == "leaky_relu":
            return F.leaky_relu(x, negative_slope=0.1)
        return F.relu(x)

    def forward(self, x: torch.Tensor, aux: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self.preset
        if (aux is not None) != _uses_aux(p):
            raise ValueError(f"{p.name} takes aux planes: {_uses_aux(p)}")
        cd = self.compute_dtype
        with _cudnn_tf32(self.allow_tf32):
            x = x.permute(0, 3, 1, 2).to(cd)
            if aux is not None:
                aux = aux.permute(0, 3, 1, 2).to(cd)
            if p.aux_bc_at_input:
                x = torch.cat([x, aux], dim=1)
            x_in = x
            if p.multiscale_front:
                x = torch.cat([self._act(getattr(self, f"ms{k}")(x, cd))
                               for k in p.multiscale_front], dim=1)
            for i in range(len(p.encoder)):
                x = self._act(getattr(self, f"enc{i}")(x, cd))
            outs = []
            for name in self.branches:
                z = x
                for i in range(len(p.decoder)):
                    z = self._act(getattr(self, f"{name}_deconv{i}")(z, cd))
                outs.append(z)
            feats = [*outs, x_in]
            if p.aux_bc_at_head:
                feats.append(aux)
            y = self._act(self.head0(torch.cat(feats, dim=1), cd))
            y = self.head1(y, torch.float32)
        return y.permute(0, 2, 3, 1)


def make_model(preset_name: str, compute_dtype: torch.dtype = torch.float32,
               kernel_init: str = "lecun_normal", allow_tf32: bool = False,
               seed: int = 0) -> CavityCNN:
    if preset_name not in PRESETS:
        raise KeyError(f"unknown preset {preset_name!r}; have {list(PRESETS)}")
    return CavityCNN(PRESETS[preset_name], compute_dtype=compute_dtype,
                     kernel_init=kernel_init, allow_tf32=allow_tf32, seed=seed)


def state_dict_from_flax(preset: CNNPreset, params: dict) -> dict:
    """The JAX package's ``CavityCNN`` parameters (the nested dict of NumPy
    arrays that ``flax.serialization`` gives, ``{"enc0": {"kernel": HWIO,
    "bias": (O,)}, ...}``) as this module's ``state_dict``: a ``Conv``
    kernel HWIO -> OIHW; a ``ConvTranspose`` kernel flipped in space and
    HWIO -> (in, out, kh, kw)."""
    out = {}
    for name, leaf in params.items():
        kernel = np.asarray(leaf["kernel"], dtype=np.float32)
        if "_deconv" in name:
            w = kernel[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            w = kernel.transpose(3, 2, 0, 1)
        out[f"{name}.weight"] = torch.from_numpy(np.array(w, dtype=np.float32))
        out[f"{name}.bias"] = torch.from_numpy(np.array(leaf["bias"], dtype=np.float32))
    model_keys = set(CavityCNN(preset).state_dict())
    if set(out) != model_keys:
        raise ValueError(f"the parameters do not fit {preset.name}: "
                         f"{sorted(set(out) ^ model_keys)}")
    return out


def stride_product(preset: CNNPreset) -> int:
    """Total encoder downsampling factor; input H/W must be divisible by it
    for the decoder to reconstruct the grid (same constraint the reference
    architectures have at their 192/384 native resolutions)."""
    p = 1
    for _, _, s in preset.encoder:
        p *= s
    return p


def check_grid(preset: CNNPreset, h: int, w: int) -> None:
    sp = stride_product(preset)
    if h % sp or w % sp:
        raise ValueError(
            f"{preset.name} downsamples by {sp}; grid {h}x{w} must be a "
            f"multiple of it (native resolution {preset.resolution})"
        )
