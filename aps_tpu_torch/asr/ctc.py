#!/usr/bin/env python
"""Encoder base of the ASR models (port of aps_tpu/asr/ctc.py::
ASREncoderBase): transform -> encoder (-> ctc head)."""

from typing import Dict, Optional

from torch import nn

from aps_tpu_torch.asr.transformer.encoder import TransformerEncoder


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
        if enc_type not in ("xfmr", "cfmr"):
            raise NotImplementedError(f"encoder {enc_type} is not ported "
                                      "yet")
        if not ead:
            raise NotImplementedError("CTC-only models are not ported yet")
        enc_kwargs = dict(enc_kwargs or {})
        self.vocab_size = vocab_size
        self.asr_transform = asr_transform
        self.encoder = TransformerEncoder(arch=enc_type,
                                          input_size=input_size,
                                          **enc_kwargs)
        self.enc_out_dim = enc_kwargs["arch_kwargs"]["att_dim"]
        self.ctc_head = nn.Linear(self.enc_out_dim, vocab_size) \
            if ctc else None

    def _decoding_prep(self, x, x_len=None):
        """x: N x S (wave) or N x T x F (features) -> (enc_out N x T x D,
        enc_len)."""
        if self.asr_transform is not None:
            x, x_len = self.asr_transform(x, x_len)
        return self.encoder(x, x_len)
