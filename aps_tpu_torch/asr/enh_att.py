#!/usr/bin/env python
"""Multi-channel enhancement front end + attention-based AM (port of
aps_tpu/asr/enh_att.py: get_enh_net, EnhASRMixin, EnhAttASR registered
"asr@enh_att" and EnhXfmrASR registered "asr@enh_xfmr").

The enh transform makes the complex64 STFT of the N x C x S waveforms
(and, for the MVDR front ends, the mask network's features); the front end
gives either an enhanced spectrum N x T x F complex (the MVDR), whose
magnitude sqrt(re^2 + im^2 + 1e-10) goes on, or features N x T x D (the
learned beamformers). The asr transform then takes what comes out as
features, asr_transform(x, None), as in aps_tpu: cmvn over every frame.

aps_tpu hands the front end's output to the asr transform without
skip_stft, so an asr transform that starts from a spectrum ("fbank",
"spectrogram", as examples/asr/chime4/conf/1b.yaml writes it) frames the
F magnitudes of each frame as samples, gets zero frames and fails with a
ZeroDivisionError; the port refuses such a transform when the model is
built. A feature pipeline ("abs-mel-log-cmvn") trains in both."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.att import AttASR, XfmrASR
from aps_tpu_torch.asr.filter.conv import EnhFrontEnds
# register the mvdr / google front ends
import aps_tpu_torch.asr.filter.google  # noqa: F401
import aps_tpu_torch.asr.filter.mvdr  # noqa: F401
from aps_tpu_torch.libs import ApsRegisters


def get_enh_net(enh_type: str, enh_kwargs: Dict,
                enh_input_size: Optional[int] = None) -> nn.Module:
    if enh_type not in EnhFrontEnds:
        raise ValueError(f"Unknown enhancement front-end: {enh_type}")
    enh_net_cls = EnhFrontEnds[enh_type]
    if enh_type[-4:] == "mvdr":
        if enh_input_size is None:
            enh_input_size = enh_kwargs["num_bins"]
        return enh_net_cls(enh_input_size=enh_input_size, **enh_kwargs)
    return enh_net_cls(**enh_kwargs)


class EnhASRMixin(object):
    """The enhancement path shared by the enh_* models."""

    def _setup_enh(self, enh_transform, enh_type: str, enh_kwargs,
                   enh_input_size):
        if enh_transform is None:
            raise ValueError(f"{type(self).__name__} needs an enh_transform")
        if self.asr_transform is not None and self.asr_transform.accept_raw:
            raise ValueError(
                f"asr_transform {self.asr_transform.feats!r} starts from the "
                "waveform, but it gets the front end's output N x T x F: "
                "aps_tpu frames the F bins of each frame as samples, gets "
                "zero frames and fails (ZeroDivisionError); use a feature "
                "pipeline such as abs-mel-log-cmvn")
        self.enh_transform = enh_transform
        self.enh_type = enh_type
        self.enh_net = get_enh_net(enh_type, dict(enh_kwargs or {}),
                                   enh_input_size=enh_input_size)

    def _enhance(self, x_pad: torch.Tensor, x_len=None):
        """x_pad: N x C x S -> (features N x T x D, frames N or None)."""
        cstft, x_len = self.enh_transform.encode(x_pad, x_len)
        if self.enh_type[-4:] == "mvdr":
            feats = self.enh_transform(cstft, training=self.training)
            x_enh = self.enh_net(feats, cstft, inp_len=x_len)
        else:
            x_enh = self.enh_net(cstft)
        if x_enh.is_complex():
            x_enh = torch.sqrt(x_enh.real**2 + x_enh.imag**2 + 1e-10)
        if self.asr_transform is not None:
            x_enh, _ = self.asr_transform(x_enh, None,
                                          training=self.training)
        return x_enh, x_len


@ApsRegisters.asr.register("asr@enh_xfmr")
class EnhXfmrASR(XfmrASR, EnhASRMixin):
    """XfmrASR behind a multi-channel enhancement front end: x_pad is
    N x C x S."""

    def __init__(self,
                 asr_input_size: int = 80,
                 enh_input_size: Optional[int] = None,
                 enh_transform: Optional[nn.Module] = None,
                 enh_type: str = "google_clp",
                 enh_kwargs: Optional[Dict] = None,
                 asr_cpt: str = "",
                 **kwargs):
        # asr_input_size and asr_cpt are read by neither package
        super(EnhXfmrASR, self).__init__(**kwargs)
        self._setup_enh(enh_transform, enh_type, enh_kwargs, enh_input_size)

    def forward(self, x_pad, x_len, y_pad, y_len, ssr=0):
        """x_pad: N x C x S -> (dec_out, enc_ctc, enc_len)"""
        x_enh, x_len = self._enhance(x_pad, x_len)
        enc_out, enc_len = self.encoder(x_enh, x_len)
        enc_ctc = self.ctc_head(enc_out) if self.ctc_head is not None \
            else enc_out
        dec_out = self.decoder(enc_out, enc_len, y_pad, y_len)
        return dec_out, enc_ctc, enc_len

    def decode_enc(self, x, x_len=None):
        """x: N x C x S -> (enc_out, enc_len, ctc logits or None)"""
        x_enh, x_len = self._enhance(x, x_len)
        enc_out, enc_len = self.encoder(x_enh, x_len)
        ctc_out = self.ctc_head(enc_out) if self.ctc_head is not None \
            else None
        return enc_out, enc_len, ctc_out


@ApsRegisters.asr.register("asr@enh_att")
class EnhAttASR(AttASR, EnhASRMixin):
    """AttASR behind a multi-channel enhancement front end: x_pad is
    N x C x S."""

    def __init__(self,
                 asr_input_size: int = 80,
                 enh_input_size: Optional[int] = None,
                 enh_transform: Optional[nn.Module] = None,
                 enh_type: str = "google_clp",
                 enh_kwargs: Optional[Dict] = None,
                 asr_cpt: str = "",
                 **kwargs):
        # asr_input_size and asr_cpt are read by neither package
        super(EnhAttASR, self).__init__(**kwargs)
        self._setup_enh(enh_transform, enh_type, enh_kwargs, enh_input_size)

    def forward(self, x_pad, x_len, y_pad, y_len, ssr=0, coins=None):
        """x_pad: N x C x S -> (dec_out, enc_ctc, enc_len)"""
        x_enh, x_len = self._enhance(x_pad, x_len)
        enc_out, enc_len = self.encoder(x_enh, x_len)
        enc_ctc = self.ctc_head(enc_out) if self.ctc_head is not None \
            else enc_out
        dec_out, _ = self.decoder(enc_out, enc_len, y_pad,
                                  schedule_sampling=ssr, coins=coins)
        return dec_out, enc_ctc, enc_len

    def decode_enc(self, x, x_len=None):
        """x: N x C x S -> (enc_out, enc_len, ctc logits or None)"""
        x_enh, x_len = self._enhance(x, x_len)
        enc_out, enc_len = self.encoder(x_enh, x_len)
        ctc_out = self.ctc_head(enc_out) if self.ctc_head is not None \
            else None
        return enc_out, enc_len, ctc_out
