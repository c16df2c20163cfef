#!/usr/bin/env python
"""Encoder base of the ASR models and the encoder-only CTC model (port of
aps_tpu/asr/ctc.py: ASREncoderBase, CtcASR registered "asr@ctc"):
transform -> encoder (-> ctc head).

A CTC-only model (ctc without ead) has no head: its encoder's output layer
gives the vocab_size logits (output_proj of a transformer encoder,
out_features of the others), as in aps_tpu."""

from typing import Dict, Optional

from torch import nn

from aps_tpu_torch.asr.base.encoder import BaseEncoder, encoder_instance
from aps_tpu_torch.asr.transformer.encoder import TransformerEncoder
from aps_tpu_torch.libs import ApsRegisters


class ASREncoderBase(nn.Module):

    def __init__(self,
                 input_size: int = 80,
                 vocab_size: int = 30,
                 ctc: bool = False,
                 ead: bool = False,
                 asr_transform: Optional[nn.Module] = None,
                 enc_type: str = "pytorch_rnn",
                 enc_proj: int = -1,
                 enc_kwargs: Optional[Dict] = None):
        super(ASREncoderBase, self).__init__()
        if not (ctc or ead):
            raise ValueError("ASREncoderBase needs ctc or ead")
        ctc_only = ctc and not ead
        enc_kwargs = dict(enc_kwargs or {})
        self.vocab_size = vocab_size
        self.asr_transform = asr_transform
        if enc_type in ("xfmr", "cfmr"):
            enc_kwargs["output_proj"] = vocab_size if ctc_only else -1
            self.encoder = TransformerEncoder(arch=enc_type,
                                              input_size=input_size,
                                              **enc_kwargs)
            self.enc_out_dim = enc_kwargs["arch_kwargs"]["att_dim"]
        else:
            self.encoder = encoder_instance(
                enc_type, input_size, vocab_size if ctc_only else enc_proj,
                enc_kwargs, BaseEncoder)
            self.enc_out_dim = enc_proj
        self.ctc_head = nn.Linear(self.enc_out_dim, vocab_size) \
            if ead and ctc else None

    def _training_prep(self, x_pad, x_len):
        """-> (enc_out N x T x D, enc_ctc N x T x V or enc_out, enc_len);
        the modules' own training flags decide dropout and batch norm."""
        if self.asr_transform is not None:
            x_pad, x_len = self.asr_transform(x_pad, x_len,
                                              training=self.training)
        enc_out, enc_len = self.encoder(x_pad, x_len)
        enc_ctc = enc_out
        if self.ctc_head is not None:
            enc_ctc = self.ctc_head(enc_out)
        return enc_out, enc_ctc, enc_len

    def _decoding_prep(self, x, x_len=None):
        """x: N x S (wave) or N x T x F (features) -> (enc_out N x T x D,
        enc_len)."""
        if self.asr_transform is not None:
            x, x_len = self.asr_transform(x, x_len)
        return self.encoder(x, x_len)


@ApsRegisters.asr.register("asr@ctc")
class CtcASR(ASREncoderBase):
    """An encoder trained with CTC alone (task asr@ctc)."""

    def __init__(self, ctc: bool = True, ead: bool = False, **kwargs):
        super(CtcASR, self).__init__(ctc=ctc, ead=ead, **kwargs)

    def forward(self, x_pad, x_len):
        """-> (enc_out, enc_ctc N x T x V, enc_len)."""
        return self._training_prep(x_pad, x_len)

    def ctc_logits(self, x, x_len=None):
        """Encoder (+ ctc head) logits for decoding: (N x T x V, lengths)."""
        enc_out, enc_len = self._decoding_prep(x, x_len)
        if self.ctc_head is not None:
            enc_out = self.ctc_head(enc_out)
        return enc_out, enc_len
