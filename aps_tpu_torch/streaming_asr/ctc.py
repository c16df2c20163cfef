#!/usr/bin/env python
"""Streaming ASR encoder and the streaming CTC model (port of
aps_tpu/streaming_asr/ctc.py: StreamingASREncoder, CtcASR registered
"streaming_asr@ctc"): transform -> (lctx / rctx zero frames) -> a
streaming encoder (-> ctc head).

enc_type "xfmr" / "cfmr" takes the chunked StreamingTransformerEncoder;
any other name one of StreamingBaseEncoder's. A CTC-only model has no
head: the encoder's output layer gives the vocab_size logits."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.encoder import encoder_instance
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.streaming_asr.base.encoder import StreamingBaseEncoder
from aps_tpu_torch.streaming_asr.transformer.encoder import \
    StreamingTransformerEncoder


class StreamingASREncoder(nn.Module):

    def __init__(self,
                 input_size: int = 80,
                 vocab_size: int = 40,
                 ctc: bool = False,
                 ead: bool = False,
                 lctx: int = -1,
                 rctx: int = -1,
                 asr_transform: Optional[nn.Module] = None,
                 enc_type: str = "pytorch_rnn",
                 enc_proj: int = -1,
                 enc_kwargs: Optional[Dict] = None):
        super(StreamingASREncoder, self).__init__()
        if not (ctc or ead):
            raise ValueError("StreamingASREncoder needs ctc or ead")
        ctc_only = ctc and not ead
        enc_kwargs = dict(enc_kwargs or {})
        self.vocab_size = vocab_size
        self.lctx, self.rctx = lctx, rctx
        self.asr_transform = asr_transform
        if enc_type in ("xfmr", "cfmr"):
            self.encoder = StreamingTransformerEncoder(
                enc_type, input_size,
                output_proj=vocab_size if ctc_only else -1, **enc_kwargs)
            self.enc_out_dim = enc_kwargs["arch_kwargs"]["att_dim"]
        else:
            self.encoder = encoder_instance(
                enc_type, input_size, vocab_size if ctc_only else enc_proj,
                enc_kwargs, StreamingBaseEncoder)
            self.enc_out_dim = enc_proj
        self.ctc_head = nn.Linear(self.enc_out_dim, vocab_size) \
            if ead and ctc else None

    def _pad_ctx(self, x_pad: torch.Tensor, x_len=None):
        """lctx zero frames before and rctx after (N x T x F), as the step
        drivers feed the first and last chunks."""
        if self.lctx + self.rctx > 0 and self.lctx >= 0 and self.rctx >= 0:
            x_pad = nn.functional.pad(x_pad, (0, 0, self.lctx, self.rctx))
            if x_len is not None:
                x_len = x_len + self.lctx + self.rctx
        return x_pad, x_len

    def _training_prep(self, x_pad, x_len):
        if self.asr_transform is not None:
            x_pad, x_len = self.asr_transform(x_pad, x_len,
                                              training=self.training)
        x_pad, x_len = self._pad_ctx(x_pad, x_len)
        enc_out, enc_len = self.encoder(x_pad, x_len)
        enc_ctc = enc_out if self.ctc_head is None else self.ctc_head(enc_out)
        return enc_out, enc_ctc, enc_len

    def _decoding_prep(self, x, x_len=None):
        if self.asr_transform is not None:
            x, x_len = self.asr_transform(x, x_len)
        x, x_len = self._pad_ctx(x, x_len)
        return self.encoder(x, x_len)


@ApsRegisters.asr.register("streaming_asr@ctc")
class CtcASR(StreamingASREncoder):
    """A streaming encoder trained with CTC (task asr@ctc)."""

    def __init__(self, ctc: bool = True, ead: bool = False, **kwargs):
        super(CtcASR, self).__init__(ctc=ctc, ead=ead, **kwargs)

    def forward(self, x_pad, x_len):
        """-> (enc_out, enc_ctc N x T x V, enc_len)."""
        return self._training_prep(x_pad, x_len)

    def step(self, chunk: torch.Tensor, state=None):
        """One streaming step of the encoder on feature frames (with the
        context the encoder needs) -> (its output, state)."""
        return self.encoder.step(chunk, state=state)

    def ctc_logits(self, x, x_len=None):
        """The offline pass for decoding: (N x T x V, lengths)."""
        enc_out, enc_len = self._decoding_prep(x, x_len)
        if self.ctc_head is not None:
            enc_out = self.ctc_head(enc_out)
        return enc_out, enc_len
