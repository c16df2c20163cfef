#!/usr/bin/env python
"""Streaming transducer ASR (port of aps_tpu/streaming_asr/transducers.py:
TransducerASR registered "streaming_asr@transducer"): a streaming encoder
and the port's RNN prediction and joint network, with the hooks the
transducer searches call (aps_tpu_torch/asr/beam_search/transducer.py);
blank = vocab_size - 1."""

from typing import Dict, Optional

import torch

from aps_tpu_torch.asr.transducer.decoder import TorchRNNDecoder
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.streaming_asr.ctc import StreamingASREncoder


@ApsRegisters.asr.register("streaming_asr@transducer")
class TransducerASR(StreamingASREncoder):

    dec_type = "rnn"

    def __init__(self, ctc: bool = False, ead: bool = True,
                 dec_type: str = "rnn", dec_kwargs: Optional[Dict] = None,
                 **kwargs):
        if dec_type != "rnn":
            raise ValueError("streaming_asr@transducer: the decoder must be "
                             "rnn")
        super(TransducerASR, self).__init__(ctc=ctc, ead=ead, **kwargs)
        dec_kwargs = dict(dec_kwargs or {})
        dec_kwargs["enc_dim"] = self.enc_out_dim
        self.decoder = TorchRNNDecoder(self.vocab_size, **dec_kwargs)

    @property
    def blank(self) -> int:
        return self.vocab_size - 1

    def forward(self, x_pad, x_len, y_pad, y_len=None):
        """y_pad: N x To+1 (blank-prefixed) -> (enc_out, dec_out N x Ti x
        To+1 x V, enc_len)."""
        enc_out, _, enc_len = self._training_prep(x_pad, x_len)
        return enc_out, self.decoder(enc_out, y_pad), enc_len

    def decode_enc(self, x, x_len=None):
        return self._decoding_prep(x, x_len)

    def decode_pred(self, pred_prev: torch.Tensor, hidden=None):
        return self.decoder.pred(pred_prev, hidden=hidden)

    def decode_joint(self, enc_frame: torch.Tensor,
                     dec_out: torch.Tensor) -> torch.Tensor:
        return self.decoder.joint(self.decoder.enc_proj(enc_frame), dec_out)
