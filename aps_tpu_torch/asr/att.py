#!/usr/bin/env python
"""Attention-based encoder-decoder ASR (port of aps_tpu/asr/att.py::
XfmrASR, registered "asr@xfmr"): the decoding hooks the batched beam search
calls. The training forward comes with the training port."""

from typing import Dict, Optional

from torch import nn

from aps_tpu_torch.asr.ctc import ASREncoderBase
from aps_tpu_torch.asr.transformer.decoder import TorchTransformerDecoder
from aps_tpu_torch.libs import ApsRegisters


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
