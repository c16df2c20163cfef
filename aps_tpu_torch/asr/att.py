#!/usr/bin/env python
"""Attention-based encoder-decoder ASR (port of aps_tpu/asr/att.py:
AttASR, registered "asr@att", and XfmrASR, "asr@xfmr"): the teacher-forced
training forward and the decoding hooks the beam searches call."""

from typing import Dict, Optional

import torch
from torch import nn

from aps_tpu_torch.asr.base.decoder import TorchRNNDecoder
from aps_tpu_torch.asr.ctc import ASREncoderBase
from aps_tpu_torch.asr.transformer.decoder import TorchTransformerDecoder
from aps_tpu_torch.libs import ApsRegisters


@ApsRegisters.asr.register("asr@att")
class AttASR(ASREncoderBase):
    """An encoder (any of BaseEncoder's, or a transformer) + the attention
    RNN decoder (+ ctc head). dec_dim is accepted and read by neither
    package: the decoder's width is dec_kwargs' hidden. Id layout as in
    aps_tpu: with a ctc head the decoder covers vocab_size - 1 ids."""

    def __init__(self,
                 input_size: int = 80,
                 vocab_size: int = 30,
                 ctc: bool = False,
                 ead: bool = True,
                 asr_transform: Optional[nn.Module] = None,
                 enc_type: str = "pytorch_rnn",
                 enc_proj: int = -1,
                 enc_kwargs: Optional[Dict] = None,
                 sos: int = -1,
                 eos: int = -1,
                 att_type: str = "ctx",
                 att_kwargs: Optional[Dict] = None,
                 dec_type: str = "rnn",
                 dec_dim: int = 512,
                 dec_kwargs: Optional[Dict] = None):
        if eos < 0 or sos < 0:
            raise RuntimeError(f"Unsupported SOS/EOS: {sos}/{eos}")
        if dec_type != "rnn":
            raise ValueError("AttASR: currently decoder must be rnn")
        super(AttASR, self).__init__(input_size=input_size,
                                     vocab_size=vocab_size,
                                     ctc=ctc,
                                     ead=ead,
                                     asr_transform=asr_transform,
                                     enc_type=enc_type,
                                     enc_proj=enc_proj,
                                     enc_kwargs=enc_kwargs)
        self.sos, self.eos = sos, eos
        self.decoder = TorchRNNDecoder(self.enc_out_dim,
                                       vocab_size - 1 if ctc else vocab_size,
                                       att_type=att_type,
                                       att_kwargs=att_kwargs,
                                       **(dec_kwargs or {}))

    def forward(self, x_pad, x_len, y_pad, y_len, ssr=0, coins=None):
        """x_pad: N x S waveforms (or N x T x F features), y_pad: N x To
        sos-prefixed ids -> (dec_out N x To x V, enc_ctc, enc_len). ssr:
        the schedule-sampling rate; coins: the decoder's draws, To of them
        (see TorchRNNDecoder)."""
        enc_out, enc_ctc, enc_len = self._training_prep(x_pad, x_len)
        dec_out, _ = self.decoder(enc_out, enc_len, y_pad,
                                  schedule_sampling=ssr, coins=coins)
        return dec_out, enc_ctc, enc_len

    def decode_enc(self, x, x_len=None):
        """-> (enc_out N x T x D, enc_len, ctc logits N x T x V or None)."""
        enc_out, enc_len = self._decoding_prep(x, x_len)
        ctc_out = self.ctc_head(enc_out) if self.ctc_head is not None \
            else None
        return enc_out, enc_len, ctc_out

    def decode_prep(self, enc_out: torch.Tensor, batch: int, enc_len=None):
        """-> (the decoder's first carry, the attention's cache)."""
        att_cache = self.decoder.att_net.prep(enc_out)
        carry = self.decoder.init_carry(batch, enc_out.shape[1], enc_len,
                                        device=enc_out.device,
                                        dtype=enc_out.dtype)
        return carry, att_cache

    def decode_step(self, tok, enc_out, carry, att_cache, enc_len=None):
        """One decoder step: tok N -> (logits N x V, the next carry)."""
        dec_hid, att_ctx, att_ali, proj, _ = carry
        pred, att_ctx, dec_hid, att_ali, proj = self.decoder.step(
            tok, enc_out, att_ctx, dec_hid=dec_hid, att_ali=att_ali,
            proj=proj, enc_len=enc_len, att_cache=att_cache)
        return pred, (dec_hid, att_ctx, att_ali, proj, pred)


@ApsRegisters.asr.register("asr@xfmr")
class XfmrASR(ASREncoderBase):
    """Transformer/conformer encoder + transformer decoder (+ ctc head).
    Id layout as in aps_tpu: the decoder covers vocab_size - 1 ids when a
    ctc head is present (the blank, vocab_size - 1, is CTC-only)."""

    def __init__(self,
                 input_size: int = 80,
                 vocab_size: int = 30,
                 ctc: bool = False,
                 ead: bool = True,
                 asr_transform: Optional[nn.Module] = None,
                 enc_type: str = "xfmr",
                 enc_proj: int = -1,
                 enc_kwargs: Optional[Dict] = None,
                 sos: int = -1,
                 eos: int = -1,
                 dec_type: str = "xfmr",
                 dec_kwargs: Optional[Dict] = None):
        super(XfmrASR, self).__init__(input_size=input_size,
                                      vocab_size=vocab_size,
                                      ctc=ctc,
                                      ead=ead,
                                      asr_transform=asr_transform,
                                      enc_type=enc_type,
                                      enc_proj=enc_proj,
                                      enc_kwargs=enc_kwargs)
        if eos < 0 or sos < 0:
            raise RuntimeError(f"Unsupported SOS/EOS: {sos}/{eos}")
        if dec_type != "xfmr":
            raise ValueError("XfmrASR: currently decoder must be xfmr")
        self.sos, self.eos = sos, eos
        dec_vocab = vocab_size - 1 if ctc else vocab_size
        self.decoder = TorchTransformerDecoder(vocab_size=dec_vocab,
                                               **(dec_kwargs or {}))

    def forward(self, x_pad, x_len, y_pad, y_len, ssr=0):
        """x_pad: N x S waveforms (or N x T x F features), y_pad: N x To
        sos-prefixed ids -> (dec_out N x To x V, enc_ctc N x T x V,
        enc_len). ssr is unused (no schedule sampling for transformer
        decoders, as in aps_tpu)."""
        enc_out, enc_ctc, enc_len = self._training_prep(x_pad, x_len)
        dec_out = self.decoder(enc_out, enc_len, y_pad, y_len)
        return dec_out, enc_ctc, enc_len

    def decode_enc(self, x, x_len=None):
        """-> (enc_out N x T x D, enc_len, ctc logits N x T x V or None)."""
        enc_out, enc_len = self._decoding_prep(x, x_len)
        ctc_out = self.ctc_head(enc_out) if self.ctc_head is not None \
            else None
        return enc_out, enc_len, ctc_out

    def decode_init_cache(self, batch: int, max_len: int, device=None):
        return self.decoder.init_cache(batch, max_len, device=device)

    def decode_prep_kv(self, enc_out):
        return self.decoder.prep_memory_kv(enc_out)

    def decode_step_inc(self, enc_out, tok, cache, t: int, enc_len=None,
                        mem_kv=None):
        return self.decoder.step_inc(enc_out, tok, cache, t,
                                     enc_len=enc_len, mem_kv=mem_kv)
