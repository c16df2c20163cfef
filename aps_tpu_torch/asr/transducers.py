#!/usr/bin/env python
"""Transducer ASR models (port of aps_tpu/asr/transducers.py:
ASRTransducerBase, TransducerASR registered "asr@transducer" and
XfmrTransducerASR, "asr@xfmr_transducer"); blank = vocab_size - 1."""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from aps_tpu_torch.asr.ctc import ASREncoderBase
from aps_tpu_torch.asr.transducer.decoder import (TorchRNNDecoder,
                                                  TorchTransformerDecoder)
from aps_tpu_torch.libs import ApsRegisters


class ASRTransducerBase(ASREncoderBase):
    """An encoder (any of BaseEncoder's, or a transformer) + a prediction
    and joint network `decoder` (built by the subclass), with the hooks
    the searches call."""

    dec_type = ""

    def __init__(self,
                 input_size: int = 80,
                 vocab_size: int = 30,
                 ctc: bool = False,
                 ead: bool = True,
                 asr_transform: Optional[nn.Module] = None,
                 enc_type: str = "pytorch_rnn",
                 enc_proj: int = -1,
                 enc_kwargs: Optional[Dict] = None,
                 dec_type: str = "",
                 dec_kwargs: Optional[Dict] = None):
        if dec_type != self.dec_type:
            raise ValueError(f"{type(self).__name__}: the decoder must be "
                             f"{self.dec_type}")
        super(ASRTransducerBase, self).__init__(input_size=input_size,
                                                vocab_size=vocab_size,
                                                ctc=ctc,
                                                ead=ead,
                                                asr_transform=asr_transform,
                                                enc_type=enc_type,
                                                enc_proj=enc_proj,
                                                enc_kwargs=enc_kwargs)
        self.dec_kwargs = dict(dec_kwargs or {})
        self.dec_kwargs["enc_dim"] = self.enc_out_dim

    @property
    def blank(self) -> int:
        return self.vocab_size - 1

    def decode_enc(self, x, x_len=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: N x S (wave) or N x T x F -> (enc_out N x T x D, enc_len)."""
        return self._decoding_prep(x, x_len)

    def decode_pred(self, pred_prev: torch.Tensor, hidden=None):
        """One prediction-network step for the search loops."""
        return self.decoder.pred(pred_prev, hidden=hidden)

    def decode_pred_fixed(self, tokens_buf: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
        """The transformer prediction net over a fixed token buffer."""
        return self.decoder.pred_fixed(tokens_buf, lengths)

    def decode_joint(self, enc_frame: torch.Tensor,
                     dec_out: torch.Tensor) -> torch.Tensor:
        """Joint logits: enc_frame N x D, dec_out N x J -> N x V."""
        return self.decoder.joint(self.decoder.enc_proj(enc_frame), dec_out)


@ApsRegisters.asr.register("asr@transducer")
class TransducerASR(ASRTransducerBase):
    """An encoder + the RNN prediction network."""

    dec_type = "rnn"

    def __init__(self, dec_type: str = "rnn", **kwargs):
        super(TransducerASR, self).__init__(dec_type=dec_type, **kwargs)
        self.decoder = TorchRNNDecoder(self.vocab_size, **self.dec_kwargs)

    def forward(self, x_pad, x_len, y_pad, y_len=None):
        """y_pad: N x To+1 (blank-prefixed) -> (enc_out, dec_out N x Ti x
        To+1 x V, enc_len)."""
        enc_out, _, enc_len = self._training_prep(x_pad, x_len)
        return enc_out, self.decoder(enc_out, y_pad), enc_len


@ApsRegisters.asr.register("asr@xfmr_transducer")
class XfmrTransducerASR(ASRTransducerBase):
    """An encoder + the transformer prediction network."""

    dec_type = "xfmr"

    def __init__(self, dec_type: str = "xfmr", **kwargs):
        super(XfmrTransducerASR, self).__init__(dec_type=dec_type, **kwargs)
        self.decoder = TorchTransformerDecoder(self.vocab_size,
                                               **self.dec_kwargs)

    def forward(self, x_pad, x_len, y_pad, y_len=None):
        enc_out, _, enc_len = self._training_prep(x_pad, x_len)
        return enc_out, self.decoder(enc_out, y_pad, tgt_len=y_len), enc_len
