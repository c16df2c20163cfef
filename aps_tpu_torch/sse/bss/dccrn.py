#!/usr/bin/env python
"""DCCRN: the deep complex convolutional-recurrent network (port of
aps_tpu/sse/bss/dccrn.py: LSTMP, ComplexLSTMP, LSTMWrapper and DCCRN
"sse@dccrn").

The U-net of aps_tpu_torch/sse/enh/dcunet.py with a recurrent bottleneck
over its flattened (C x F) features: a complex one (ComplexLSTMP, the two
real LSTMPs "real" and "imag" each called on both halves, (a + bi)(c + di))
or a real one. The bottleneck's output is summed with its input
(connection "sum") or concatenated before it on the channel axis ("cat",
which doubles the first decoder block's input). One decoder gives every
speaker's mask (share_decoder), or one decoder each. Training mode "freq"
gives the masks (complex64 N x F x T for the complex model), "time" the
masked mixtures as waveforms."""

from typing import Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.rnn import StackedRNN
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.sse.base import MaskNonLinear, SSEBase
from aps_tpu_torch.sse.enh.dcunet import (Decoder, Encoder,
                                          bounded_complex_mask,
                                          spectra_input, unet_config)


class LSTMP(nn.Module):
    """A stacked LSTM and a projection back to the input's width (no bias)
    over N x T x C x F, its inner axes flattened."""

    def __init__(self, in_features: int, hidden_size: int,
                 num_layers: int = 2, dropout: float = 0,
                 bidirectional: bool = False):
        super(LSTMP, self).__init__()
        self.stacked_rnn = StackedRNN(in_features, hidden_size,
                                      num_layers=num_layers,
                                      rnn_type="lstm",
                                      bidirectional=bidirectional,
                                      dropout=dropout)
        self.dense = nn.Linear(self.stacked_rnn.output_size, in_features,
                               bias=False)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        N, T, C, F = inp.shape
        out = self.dense(self.stacked_rnn(inp.reshape(N, T, C * F)))
        return out.reshape(N, T, C, F)


class ComplexLSTMP(nn.Module):
    """(a + bi)(c + di) of two real LSTMPs over N x T x C x 2F: each of
    `real` and `imag` runs on both halves with its own weights."""

    def __init__(self, in_features: int, hidden_size: int,
                 num_layers: int = 2, dropout: float = 0,
                 bidirectional: bool = False):
        super(ComplexLSTMP, self).__init__()
        kwargs = dict(num_layers=num_layers, dropout=dropout,
                      bidirectional=bidirectional)
        self.real = LSTMP(in_features, hidden_size, **kwargs)
        self.imag = LSTMP(in_features, hidden_size, **kwargs)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        inp_r, inp_i = torch.chunk(inp, 2, -1)
        out_r = self.real(inp_r) - self.imag(inp_i)
        out_i = self.real(inp_i) + self.imag(inp_r)
        return torch.cat([out_r, out_i], -1)


class LSTMWrapper(nn.Module):
    """The real or complex bottleneck over N x C x (2)F x T (the LSTMs run
    over T on N x T x C x (2)F)."""

    def __init__(self, in_features: int, num_layers: int = 2,
                 dropout: float = 0, hidden_size: int = 512,
                 cplx: bool = True, bidirectional: bool = False):
        super(LSTMWrapper, self).__init__()
        kwargs = dict(num_layers=num_layers, dropout=dropout,
                      bidirectional=bidirectional)
        if cplx:
            self.cplx_lstmp = ComplexLSTMP(in_features, hidden_size, **kwargs)
        else:
            self.lstmp = LSTMP(in_features, hidden_size, **kwargs)
        self.cplx = cplx

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        layer = self.cplx_lstmp if self.cplx else self.lstmp
        return layer(inp.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@ApsRegisters.sse.register("sse@dccrn")
class DCCRN(SSEBase):
    """Deep complex convolutional-recurrent separation / enhancement."""

    def __init__(self,
                 enh_transform: Optional[nn.Module] = None,
                 cplx: bool = True,
                 K: str = "3,3;3,3;3,3;3,3;3,3;3,3;3,3",
                 S: str = "2,1;2,1;2,1;2,1;2,1;2,1;2,1",
                 P: str = "1,1,1,1,1,1,1",
                 O: str = "0,0,0,0,0,0,0",
                 C: str = "16,32,64,64,128,128,256",
                 num_spks: int = 2,
                 connection: str = "sum",
                 rnn_hidden: int = 512,
                 rnn_layers: int = 2,
                 rnn_resize: int = 1536,
                 rnn_dropout: float = 0,
                 rnn_bidir: bool = False,
                 causal_conv: bool = False,
                 share_decoder: bool = True,
                 non_linear: str = "tanh",
                 training_mode: str = "time"):
        super(DCCRN, self).__init__(enh_transform=enh_transform,
                                    training_mode=training_mode)
        if enh_transform is None:
            raise ValueError("DCCRN needs an enh_transform")
        K, S, C, P, O = unet_config(K, S, C, P, O)
        self.cplx, self.num_spks = cplx, num_spks
        self.connection = connection
        self.share_decoder = share_decoder
        self.mask_act = MaskNonLinear(non_linear, enable="all_wo_softmax")
        self.stft_ctx = enh_transform.ctx("forward_stft")
        self.enc = Encoder(cplx, K, S, [1] + C, P, causal=causal_conv)
        C_dec = list(C)
        if connection == "cat":
            C_dec[-1] *= 2
        self.num_decoders = 1 if share_decoder else num_spks
        for i in range(self.num_decoders):
            self.add_module(f"decoders_{i}", Decoder(
                cplx, K[::-1], S[::-1],
                C_dec[::-1] + [num_spks if share_decoder else 1], P[::-1],
                O[::-1], causal=causal_conv, connection=connection))
        self.rnn = LSTMWrapper(rnn_resize // 2 if cplx else rnn_resize,
                               dropout=rnn_dropout, num_layers=rnn_layers,
                               hidden_size=rnn_hidden,
                               bidirectional=rnn_bidir, cplx=cplx)

    def _sep(self, m: torch.Tensor, stft: torch.Tensor, mode: str = "freq"):
        """m: N x (2)F x T -> the mask (mode freq: complex N x F x T for the
        complex model) or the masked mixture as a waveform N x S."""
        if self.cplx:
            mask = bounded_complex_mask(m, self.mask_act)
        else:
            mask = self.mask_act(m)
        if mode == "freq":
            return mask
        return self.stft_ctx.inverse(stft * mask)

    def _tf_mask(self, stft: torch.Tensor) -> torch.Tensor:
        """-> masks N x S x (2)F x T"""
        enc_h, h = self.enc(spectra_input(stft, self.cplx))
        out_h = self.rnn(h)
        h = h + out_h if self.connection == "sum" else torch.cat([out_h, h],
                                                                  1)
        enc_h = enc_h[::-1]
        return torch.cat([
            getattr(self, f"decoders_{i}")(h, enc_h)
            for i in range(self.num_decoders)
        ], 1)

    def infer_batch(self, mix: torch.Tensor, mode: str = "time"):
        """mix: N x S -> [N x S' or masks N x F x T, ...] (one tensor for
        one speaker)"""
        stft = self.stft_ctx.forward(mix)
        masks = self._tf_mask(stft)
        sep = [self._sep(masks[:, i], stft, mode=mode)
               for i in range(self.num_spks)]
        return sep[0] if self.num_spks == 1 else sep

    def forward(self, s: torch.Tensor):
        self.check_args(s, training=True, valid_dim=[2])
        return self.infer_batch(s, self.training_mode)

    def infer(self, mix: torch.Tensor, mode: str = "time"):
        """mix: S -> separated signal(s) or masks; eval mode."""
        self.check_args(mix, training=False, valid_dim=[1])
        sep = self.infer_batch(mix[None], mode)
        return sep[0] if self.num_spks == 1 else [s[0] for s in sep]
