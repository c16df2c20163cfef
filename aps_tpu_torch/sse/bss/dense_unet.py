#!/usr/bin/env python
"""DenseUnet separation / enhancement (port of
aps_tpu/sse/bss/dense_unet.py: EncoderBlock, DecoderBlock, DenseBlock,
EncoderDenseBlock, DecoderDenseBlock and DenseUnet "sse@dense_unet").

Layout: channel-first N x C x F x T (aps_tpu: channel-last N x F x T x C),
the concatenations on the channel axis. The norm "IN" normalises each
(sample, channel) over F x T without parameters, "BN" is a BatchNorm
(aps_tpu's epsilon 1e-5 and momentum 0.9). The blocks need their input
channels here, which flax infers: a dense block's conv_i reads its input
and the i outputs before it, and each decoder block the previous block's
output concatenated with the encoder's output of the same depth (the
first: the bottleneck LSTM's output concatenated with its input). The
transposed convs keep aps_tpu's geometry as torch's padding and
output_padding (aps_tpu_torch/sse/enh/dcunet.py says when they agree)."""

from typing import Optional, Tuple

import torch
import torch.nn.functional as tf
from torch import nn

from aps_tpu_torch.asr.base.component import BatchNorm2d
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import MaskNonLinear, SSEBase
from aps_tpu_torch.sse.bss.dccrn import LSTMWrapper
from aps_tpu_torch.sse.enh.dcunet import parse_1dstr, parse_2dstr


def _instance_norm(x: torch.Tensor) -> torch.Tensor:
    """IN: each (sample, channel) of N x C x F x T over F x T."""
    var, mean = torch.var_mean(x, (2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class _Block(nn.Module):
    """A conv, then (but for a first or last layer) ELU, dropout and the
    norm: `norm`, a BatchNorm (aps_tpu's epsilon 1e-5, momentum 0.9,
    torch's 0.1), for any norm but "IN"."""

    def _post_init(self, channels: int, norm: str, dropout: float,
                   plain: bool):
        self.plain = plain
        self.drop = nn.Dropout(dropout) if dropout > 0 and not plain \
            else None
        self.norm = BatchNorm2d(channels, eps=1e-5, momentum=0.1) \
            if norm != "IN" and not plain else None

    def _post(self, out: torch.Tensor) -> torch.Tensor:
        if self.plain:
            return out
        out = tf.elu(out)
        if self.drop is not None:
            out = self.drop(out)
        return _instance_norm(out) if self.norm is None else self.norm(out)


class EncoderBlock(_Block):
    """conv -> ELU -> dropout -> norm (the first layer: the conv alone)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (1, 1), dropout: float = 0,
                 norm: str = "IN", first_layer: bool = False):
        super(EncoderBlock, self).__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, tuple(kernel_size),
                              stride=tuple(stride), padding=tuple(padding))
        self._post_init(out_channels, norm, dropout, first_layer)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self._post(self.conv(inp))


class DecoderBlock(_Block):
    """transposed conv -> ELU -> dropout -> norm (the last layer: the conv
    alone)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (1, 1),
                 output_padding: Tuple[int, int] = (0, 0),
                 dropout: float = 0, norm: str = "IN",
                 last_layer: bool = False):
        super(DecoderBlock, self).__init__()
        if any(o > p for o, p in zip(output_padding, padding)):
            raise ValueError(f"output padding {tuple(output_padding)} > "
                             f"padding {tuple(padding)}: aps_tpu's slice of "
                             "the VALID output would cut it short")
        self.conv_t = nn.ConvTranspose2d(in_channels, out_channels,
                                         tuple(kernel_size),
                                         stride=tuple(stride),
                                         padding=tuple(padding),
                                         output_padding=tuple(output_padding))
        self._post_init(out_channels, norm, dropout, last_layer)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self._post(self.conv_t(inp))


class DenseBlock(nn.Module):
    """num_layers 3x3 convs conv_<i>, each on the concatenation of the
    block's input and every output before it; growth_rate channels each,
    out_channels the last."""

    def __init__(self, in_channels: int, out_channels: int,
                 growth_rate: int, kernel_size: Tuple[int, int] = (3, 3),
                 num_layers: int = 5, norm: str = "IN"):
        super(DenseBlock, self).__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"conv_{i}", EncoderBlock(
                in_channels + i * growth_rate,
                growth_rate if i != num_layers - 1 else out_channels,
                kernel_size=tuple(kernel_size), stride=(1, 1), norm=norm,
                padding=(1, 1)))

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        inputs = [inp]
        for i in range(self.num_layers):
            inp = getattr(self, f"conv_{i}")(torch.cat(inputs, 1))
            inputs.append(inp)
        return inp


class EncoderDenseBlock(nn.Module):
    """An encoder block (sub1) and a dense block (sub2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1), dropout: float = 0,
                 padding: Tuple[int, int] = (1, 1), norm: str = "IN",
                 inner_dense_layer: int = 5, first_layer: bool = False):
        super(EncoderDenseBlock, self).__init__()
        self.sub1 = EncoderBlock(in_channels, out_channels,
                                 kernel_size=kernel_size, stride=stride,
                                 padding=padding, dropout=dropout, norm=norm,
                                 first_layer=first_layer)
        self.sub2 = DenseBlock(out_channels, out_channels, out_channels,
                               num_layers=inner_dense_layer, norm=norm)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self.sub2(self.sub1(inp))


class DecoderDenseBlock(nn.Module):
    """A dense block (sub1) and a decoder block (sub2)."""

    def __init__(self, inp_channels: int, in_channels: int,
                 out_channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (1, 1),
                 output_padding: Tuple[int, int] = (0, 0),
                 dropout: float = 0, norm: str = "IN",
                 inner_dense_layer: int = 5, last_layer: bool = False,
                 last_out_channels: int = 2):
        super(DecoderDenseBlock, self).__init__()
        self.sub1 = DenseBlock(inp_channels, in_channels * 2, in_channels,
                               num_layers=inner_dense_layer, norm=norm)
        self.sub2 = DecoderBlock(
            in_channels * 2,
            last_out_channels if last_layer else out_channels,
            kernel_size=kernel_size, stride=stride, padding=padding,
            dropout=dropout, output_padding=output_padding, norm=norm,
            last_layer=last_layer)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        return self.sub2(self.sub1(inp))


@ApsRegisters.sse.register("sse@dense_unet")
class DenseUnet(SSEBase):
    """Boosted (dense) U-net separation model."""

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 inp_cplx: bool = False,
                 out_cplx: bool = False,
                 K: str = "3,3;3,3;3,3;3,3;3,3;3,3;3,3;3,3",
                 S: str = "1,1;2,1;2,1;2,1;2,1;2,1;2,1;2,1",
                 P: str = "0,1;0,1;0,1;0,1;0,1;0,1;0,1;0,1;0,1",
                 O: str = "0,0,0,0,0,0,0,0",
                 enc_channel: str = "16,32,32,32,32,64,128,384",
                 dec_channel: str = "32,16,32,32,32,32,64,128",
                 conv_dropout: float = 0,
                 norm: str = "IN",
                 num_spks: int = 2,
                 rnn_hidden: int = 512,
                 rnn_layers: int = 2,
                 rnn_resize: int = 512,
                 rnn_bidir: bool = False,
                 rnn_dropout: float = 0,
                 num_dense_blocks: int = 4,
                 non_linear: str = "sigmoid",
                 non_linear_scale: float = 1,
                 non_linear_vmax: Optional[float] = None,
                 training_mode: str = "freq"):
        super(DenseUnet, self).__init__(enh_transform=enh_transform,
                                        training_mode=training_mode)
        if enh_transform is None:
            raise ValueError("DenseUnet needs an enh_transform")
        self.inp_cplx, self.out_cplx = inp_cplx, out_cplx
        self.num_spks = num_spks
        self.mask_act = MaskNonLinear(
            non_linear, enable="all_wo_softmax", scale=non_linear_scale,
            vmax=non_linear_vmax) if non_linear else None
        self.rnn = LSTMWrapper(rnn_resize, hidden_size=rnn_hidden,
                               cplx=False, dropout=rnn_dropout,
                               num_layers=rnn_layers,
                               bidirectional=rnn_bidir)
        K, S, P = parse_2dstr(K), parse_2dstr(S), parse_2dstr(P)
        O = parse_1dstr(O)
        enc_c, dec_c = parse_1dstr(enc_channel), parse_1dstr(dec_channel)
        self.total = total = len(enc_c)
        self.num_dense_blocks = num_dense_blocks
        cin = 3 if inp_cplx else 1
        for i in range(total):
            kwargs = dict(kernel_size=K[i], stride=S[i], padding=P[i],
                          dropout=conv_dropout, norm=norm,
                          first_layer=(i == 0))
            block = EncoderDenseBlock if i < num_dense_blocks else \
                EncoderBlock
            self.add_module(f"enc_{i}", block(cin, enc_c[i], **kwargs))
            cin = enc_c[i]
        Kd, Sd, Pd, Od = K[::-1], S[::-1], P[::-1], O[::-1]
        dec_out = dec_c[::-1] + [num_spks * (2 if out_cplx else 1)]
        enc_rev = enc_c[::-1]
        # the bottleneck's output and its input
        cin = 2 * enc_c[-1]
        for i in range(total):
            last = i == total - 1
            if i:
                cin += enc_rev[i]
            kwargs = dict(kernel_size=Kd[i], stride=Sd[i], padding=Pd[i],
                          output_padding=(Od[i], 0), dropout=conv_dropout,
                          norm=norm, last_layer=last)
            if i < total - num_dense_blocks:
                block = DecoderBlock(cin, dec_out[i], **kwargs)
                cin = dec_out[i]
            else:
                block = DecoderDenseBlock(cin, enc_rev[i], dec_out[i],
                                          last_out_channels=dec_out[-1],
                                          **kwargs)
                cin = dec_out[-1] if last else dec_out[i]
            self.add_module(f"dec_{i}", block)

    def _encode_decode(self, s: torch.Tensor) -> torch.Tensor:
        """s: N x C x F x T -> N x S(x 2) x F x T"""
        enc_h = []
        x = s
        for i in range(self.total):
            x = getattr(self, f"enc_{i}")(x)
            enc_h.append(x)
        enc_h, h = enc_h[:-1][::-1], enc_h[-1]
        x = torch.cat([self.rnn(h), h], 1)
        for i in range(self.total):
            if i:
                x = torch.cat([x, enc_h[i - 1]], 1)
            x = getattr(self, f"dec_{i}")(x)
        return x

    def sep(self, m: torch.Tensor, stft: torch.Tensor, mode: str = "freq"):
        """m: N x (2|1) x F x T -> the mask or spectrum (mode freq) or the
        waveform N x S."""
        sr, si = stft.real, stft.imag
        decode = lambda s: self.enh_transform.decode([s])[0]  # noqa: E731
        if self.out_cplx:
            mr, mi = m[:, 0], m[:, 1]
            if self.mask_act is None:
                s = torch.complex(mr, mi)
                return s if mode == "freq" else decode(s)
            m_abs = torch.sqrt(mr**2 + mi**2)
            m_mag = self.mask_act(m_abs)
            if mode == "freq":
                return m_mag
            mr, mi = m_mag * mr / m_abs, m_mag * mi / m_abs
            return decode(stft * torch.complex(mr, mi))
        if self.mask_act is not None:
            mm = self.mask_act(m[:, 0])
            return mm if mode == "freq" else decode(stft * mm)
        mm = m[:, 0]
        if mode == "freq":
            return mm
        s_abs = torch.sqrt(sr**2 + si**2)
        return decode(torch.complex(mm * sr / s_abs, mm * si / s_abs))

    def infer_batch(self, mix: torch.Tensor, mode: str = "time"):
        stft, _ = self.enh_transform.encode(mix, None)
        if self.inp_cplx:
            sr, si = stft.real, stft.imag
            s = torch.stack([sr, si, torch.sqrt(sr**2 + si**2)], 1)
        else:
            feats = self.enh_transform(stft, training=self.training)
            # N x T x F -> N x 1 x F x T
            s = feats.transpose(1, 2)[:, None]
        spk_m = self._encode_decode(s)
        if self.num_spks == 1:
            return self.sep(spk_m, stft, mode=mode)
        return [self.sep(m, stft, mode=mode)
                for m in torch.chunk(spk_m, self.num_spks, 1)]

    def forward(self, s: torch.Tensor):
        self.check_args(s, training=True, valid_dim=[2])
        return self.infer_batch(s, self.training_mode)

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        self.check_args(mix, training=False, valid_dim=[1])
        sep = self.infer_batch(mix[None], mode)
        return sep[0] if self.num_spks == 1 else [s[0] for s in sep]
