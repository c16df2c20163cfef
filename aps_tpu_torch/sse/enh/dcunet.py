#!/usr/bin/env python
"""DCUNet: the real or complex U-net of speech enhancement (port of
aps_tpu/sse/enh/dcunet.py: parse_1dstr / parse_2dstr, EncoderBlock,
DecoderBlock, Encoder, Decoder and DCUNet "sse@dcunet").

Layout: channel-first N x C x (2)F x T, the spatial axes (F, T) in
aps_tpu's order. A complex tensor rides as [real; imag] stacked on the F
axis, as in aps_tpu, so each complex conv is the pair of real convs
"real" and "imag" applied as (a + bi)(c + di): real(a) - imag(b) and
imag(a) + real(b). Each half has its own BatchNorm (bn_r, bn_i; aps_tpu's
epsilon 1e-5 and momentum 0.9, torch's 0.1, the running variance from the
biased batch variance). The port's STFT is complex64: the model packs its
real and imaginary parts at the input and builds the complex spectrum of
the masked output from the two halves.

The transposed convs are flax ConvTranspose with transpose_kernel=True in
aps_tpu (kernel (kf, kt, O, I) <-> ConvTranspose2d weight (I, O, kf, kt),
no tap reversal; aps_tpu_torch/convert.py), whose VALID output aps_tpu
slices to torch's geometry; here that geometry is the layer's own padding
(freq_pad, kt - 1 - tap) and output_padding (freq_out_pad, 0), and the
causal crop of the last kt - 1 frames. The slice equals it while
freq_out_pad <= freq_pad, which the port requires: past that aps_tpu's
slice cuts the output short."""

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as tf
from torch import nn

from aps_tpu_torch.asr.base.component import BatchNorm2d
from aps_tpu_torch.const import EPSILON
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import MaskNonLinear, SSEBase


def parse_1dstr(sstr: str) -> List[int]:
    return list(map(int, sstr.split(",")))


def parse_2dstr(sstr: str) -> List[List[int]]:
    return [parse_1dstr(tok) for tok in sstr.split(";")]


def _batch_norm(channels: int) -> nn.Module:
    # aps_tpu's BatchNorm: epsilon 1e-5, momentum 0.9 (torch: 0.1)
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def complex_apply(real: nn.Module, imag: nn.Module,
                  x: torch.Tensor) -> torch.Tensor:
    """A complex linear layer on [real; imag] stacked on the F axis (2) of
    N x C x 2F x T: (a + bi)(c + di)."""
    xr, xi = torch.chunk(x, 2, 2)
    return torch.cat([real(xr) - imag(xi), imag(xr) + real(xi)], 2)


def _split_norm(x: torch.Tensor, bn_r: nn.Module,
                bn_i: nn.Module) -> torch.Tensor:
    xr, xi = torch.chunk(x, 2, 2)
    return torch.cat([bn_r(xr), bn_i(xi)], 2)


class Conv2dTorch(nn.Module):
    """A conv with torch's (freq, time) padding; causal pads the time axis
    on the left only."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int],
                 freq_pad: int, causal: bool = False):
        super(Conv2dTorch, self).__init__()
        kt = kernel_size[1]
        tap = kt - 1 if causal else (kt - 1) // 2
        self.padding = (tap, 0 if causal else tap, freq_pad, freq_pad)
        self.conv = nn.Conv2d(in_channels, out_channels, tuple(kernel_size),
                              stride=tuple(stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(tf.pad(x, self.padding))


class ConvTranspose2dTorch(nn.Module):
    """A transposed conv with torch's output geometry (padding, output
    padding) and, when causal, the last kt - 1 frames cropped."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int], stride: Tuple[int, int],
                 freq_pad: int, freq_out_pad: int, causal: bool = False):
        super(ConvTranspose2dTorch, self).__init__()
        if freq_out_pad > freq_pad:
            raise ValueError(f"output padding {freq_out_pad} > padding "
                             f"{freq_pad}: aps_tpu's slice of the VALID "
                             "output would cut it short")
        kt = kernel_size[1]
        tap = kt - 1 if causal else (kt - 1) // 2
        self.crop = kt - 1 if causal and kt > 1 else 0
        self.conv_t = nn.ConvTranspose2d(in_channels, out_channels,
                                         tuple(kernel_size),
                                         stride=tuple(stride),
                                         padding=(freq_pad, kt - 1 - tap),
                                         output_padding=(freq_out_pad, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_t(x)
        return y[..., :-self.crop] if self.crop else y


class EncoderBlock(nn.Module):
    """(complex) conv -> BatchNorm (each half its own) -> leaky ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: int = 0,
                 causal: bool = False, cplx: bool = True):
        super(EncoderBlock, self).__init__()
        conv = lambda: Conv2dTorch(in_channels, out_channels,  # noqa: E731
                                   kernel_size, stride, padding,
                                   causal=causal)
        self.cplx = cplx
        if cplx:
            self.real_conv, self.imag_conv = conv(), conv()
            self.bn_r = _batch_norm(out_channels)
            self.bn_i = _batch_norm(out_channels)
        else:
            self.plain_conv = conv()
            self.bn = _batch_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: N x C x (2)F x T"""
        if self.cplx:
            y = _split_norm(complex_apply(self.real_conv, self.imag_conv, x),
                            self.bn_r, self.bn_i)
        else:
            y = self.bn(self.plain_conv(x))
        return tf.leaky_relu(y, 0.01)


class DecoderBlock(nn.Module):
    """(complex) transposed conv -> BatchNorm -> leaky ReLU (the last layer:
    the conv alone)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: int = 0,
                 output_padding: int = 0, causal: bool = False,
                 cplx: bool = True, last_layer: bool = False):
        super(DecoderBlock, self).__init__()
        conv = lambda: ConvTranspose2dTorch(  # noqa: E731
            in_channels, out_channels, kernel_size, stride, padding,
            output_padding, causal=causal)
        self.cplx, self.last_layer = cplx, last_layer
        if cplx:
            self.real_convt, self.imag_convt = conv(), conv()
        else:
            self.plain_convt = conv()
        if not last_layer:
            if cplx:
                self.bn_r = _batch_norm(out_channels)
                self.bn_i = _batch_norm(out_channels)
            else:
                self.bn = _batch_norm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.cplx:
            y = complex_apply(self.real_convt, self.imag_convt, x)
        else:
            y = self.plain_convt(x)
        if self.last_layer:
            return y
        y = _split_norm(y, self.bn_r, self.bn_i) if self.cplx else self.bn(y)
        return tf.leaky_relu(y, 0.01)


class Encoder(nn.Module):
    """enc_<i> blocks; returns the hidden outputs of all but the last and
    the last one."""

    def __init__(self, cplx: bool, K: List, S: List, C: List, P: List,
                 causal: bool = False):
        super(Encoder, self).__init__()
        self.num_layers = len(K)
        for i, k in enumerate(K):
            self.add_module(f"enc_{i}", EncoderBlock(
                C[i], C[i + 1], tuple(k), stride=tuple(S[i]), padding=P[i],
                cplx=cplx, causal=causal))

    def forward(self, x: torch.Tensor):
        enc_h = []
        for i in range(self.num_layers):
            x = getattr(self, f"enc_{i}")(x)
            if i + 1 != self.num_layers:
                enc_h.append(x)
        return enc_h, x


class Decoder(nn.Module):
    """dec_<i> blocks, the encoder's outputs summed in or concatenated on
    the channel axis before every block but the first."""

    def __init__(self, cplx: bool, K: List, S: List, C: List, P: List,
                 O: List, causal: bool = False, connection: str = "sum"):
        super(Decoder, self).__init__()
        if connection not in ("cat", "sum"):
            raise ValueError(f"Unknown connection mode: {connection}")
        self.connection = connection
        self.num_layers = len(K)
        for i, k in enumerate(K):
            # a concatenated skip doubles the block's input channels
            cin = C[i] * (2 if connection == "cat" and i else 1)
            self.add_module(f"dec_{i}", DecoderBlock(
                cin, C[i + 1], tuple(k), stride=tuple(S[i]), padding=P[i],
                output_padding=O[i], causal=causal, cplx=cplx,
                last_layer=(i == self.num_layers - 1)))

    def forward(self, x: torch.Tensor, enc_h: List[torch.Tensor]):
        for i in range(self.num_layers):
            if i:
                x = x + enc_h[i - 1] if self.connection == "sum" else \
                    torch.cat([x, enc_h[i - 1]], 1)
            x = getattr(self, f"dec_{i}")(x)
        return x


def unet_config(K: str, S: str, C: str, P: str, O: str):
    """The encoder's and the decoder's layer lists from the "a,b;c,d"
    strings of nnet_conf: (K, S, C, P, O) parsed."""
    return (parse_2dstr(K), parse_2dstr(S), parse_1dstr(C), parse_1dstr(P),
            parse_1dstr(O))


def spectra_input(stft: torch.Tensor, cplx: bool,
                  eps: float = EPSILON) -> torch.Tensor:
    """N x F x T complex -> the U-net's input N x 1 x (2)F x T: [real; imag]
    on the F axis, or the magnitude sqrt(re^2 + im^2 + eps)."""
    sr, si = stft.real, stft.imag
    if cplx:
        return torch.cat([sr, si], -2)[:, None]
    return torch.sqrt(sr**2 + si**2 + eps)[:, None]


def bounded_complex_mask(m: torch.Tensor, act) -> torch.Tensor:
    """A [real; imag] mask N x 2F x T -> complex N x F x T whose magnitude
    is act(|m|), |m| = sqrt(mr^2 + mi^2 + EPSILON)."""
    mr, mi = torch.chunk(m, 2, -2)
    m_abs = torch.sqrt(mr**2 + mi**2 + EPSILON)
    m_mag = act(m_abs)
    return torch.complex(m_mag * mr / m_abs, m_mag * mi / m_abs)


@ApsRegisters.sse.register("sse@dcunet")
class DCUNet(SSEBase):
    """Real or complex U-net over the STFT: masks the mixture's spectrum
    (complex: a tanh-bounded complex mask; real: mask_act of the magnitude
    mask) and gives waveforms, one per branch."""

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 cplx: bool = True,
                 K: str = "7,5;7,5;7,5;5,3;5,3;5,3;5,3",
                 S: str = "2,1;2,1;2,1;2,1;2,1;2,1;2,1",
                 C: str = "32,32,64,64,64,64,64",
                 P: str = "1,1,1,1,1,1,1",
                 O: str = "0,0,0,0,0,0,0",
                 num_branch: int = 1,
                 non_linear: str = "tanh",
                 causal_conv: bool = False,
                 connection: str = "sum",
                 training_mode: str = "freq"):
        super(DCUNet, self).__init__(enh_transform=enh_transform,
                                     training_mode=training_mode)
        if enh_transform is None:
            raise ValueError("DCUNet needs an enh_transform")
        K, S, C, P, O = unet_config(K, S, C, P, O)
        self.cplx, self.num_branch = cplx, num_branch
        self.stft_ctx = enh_transform.ctx("forward_stft")
        self.enc = Encoder(cplx, K, S, [1] + C, P, causal=causal_conv)
        self.dec = Decoder(cplx, K[::-1], S[::-1], C[::-1] + [num_branch],
                           P[::-1], O[::-1], causal=causal_conv,
                           connection=connection)
        # cplx: always tanh (aps_tpu warns when non_linear says otherwise)
        self.mask_act = None if cplx else MaskNonLinear(non_linear,
                                                        enable="common")

    def _sep(self, m: torch.Tensor, stft: torch.Tensor) -> torch.Tensor:
        """m: N x (2)F x T -> waveform N x S"""
        if self.cplx:
            masked = stft * bounded_complex_mask(m, torch.tanh)
        else:
            masked = stft * self.mask_act(m)
        return self.stft_ctx.inverse(masked)

    def _tf_mask(self, stft: torch.Tensor) -> torch.Tensor:
        """-> masks N x B x (2)F x T"""
        enc_h, h = self.enc(spectra_input(stft, self.cplx))
        return self.dec(h, enc_h[::-1])

    def infer_batch(self, mix: torch.Tensor, mode: str = "time"):
        """mix: N x S -> waveforms N x S' (a list for several branches);
        the model has no frequency mode."""
        stft = self.stft_ctx.forward(mix)
        masks = self._tf_mask(stft)
        if self.num_branch == 1:
            return self._sep(masks[:, 0], stft)
        return [self._sep(masks[:, i], stft) for i in range(self.num_branch)]

    def forward(self, s: torch.Tensor):
        self.check_args(s, training=True, valid_dim=[2])
        return self.infer_batch(s)

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        """mix: S -> S' (a list for several branches); eval mode."""
        self.check_args(mix, training=False, valid_dim=[1])
        sep = self.infer_batch(mix[None], mode)
        return sep[0] if self.num_branch == 1 else [s[0] for s in sep]
