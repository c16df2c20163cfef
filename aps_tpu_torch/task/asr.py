#!/usr/bin/env python
"""ASR tasks (port of aps_tpu/task/asr.py: CtcTask "asr@ctc",
CtcXentHybridTask "asr@ctc_xent", TransducerTask "asr@transducer",
LmXentTask "asr@lm", compute_accu, prep_asr_label, load_label_count)."""

import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as tf
from torch import nn

from aps_tpu_torch.const import IGNORE_ID
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.ops.rnnt import rnnt_loss
from aps_tpu_torch.task.base import Task
from aps_tpu_torch.task.objf import ce_objf, ctc_objf, ls_objf

__all__ = ["CtcTask", "CtcXentHybridTask", "TransducerTask", "LmXentTask"]


def compute_accu(dec_out: torch.Tensor, tgt_pad: torch.Tensor):
    """Token accuracy over non-ignored positions -> (accu, total)."""
    pred = dec_out.argmax(-1)
    mask = tgt_pad != IGNORE_ID
    total = mask.sum()
    return ((pred == tgt_pad) & mask).sum() / total, total


def prep_asr_label(tgt_ori: torch.Tensor,
                   tgt_len: torch.Tensor,
                   pad_value: int,
                   sos_value: int = -1,
                   eos_value: int = -1):
    """(tgt_infer sos-prefixed input, tgt_refer eos-suffixed reference)."""
    tgt_infer = tgt_ori
    if pad_value != IGNORE_ID:
        tgt_infer = tgt_ori.masked_fill(tgt_ori == IGNORE_ID, pad_value)
    if sos_value >= 0:
        tgt_infer = tf.pad(tgt_infer, (1, 0), value=sos_value)
    tgt_refer = None
    if eos_value >= 0:
        tgt_refer = tf.pad(tgt_ori, (0, 1), value=IGNORE_ID)
        pos = torch.arange(tgt_refer.shape[-1], device=tgt_ori.device)
        tgt_refer = tgt_refer.masked_fill(pos[None, :] == tgt_len[:, None],
                                          eos_value)
    return tgt_infer, tgt_refer


def load_label_count(label_count: str) -> Optional[torch.Tensor]:
    if not label_count:
        return None
    counts = []
    with open(label_count, "r") as fd:
        for raw_line in fd:
            toks = raw_line.strip().split()
            if len(toks) not in (1, 2):
                raise RuntimeError(f"Label count format error: {raw_line}")
            counts.append(float(toks[0] if len(toks) == 1 else toks[1]))
    counts = np.asarray(counts, dtype=np.float32)
    if np.sum(counts == 0):
        warnings.warn(f"Got {int(np.sum(counts == 0))} zero-count labels")
    return torch.from_numpy(np.maximum(counts, 1))


class ASRTask(Task):

    def __init__(self, nnet: nn.Module, reduction: str = "batchmean",
                 description: str = "unknown"):
        super(ASRTask, self).__init__(nnet, description=description)
        if reduction not in ("mean", "batchmean"):
            raise ValueError(f"Unsupported reduction: {reduction}")
        self.reduction = reduction


@ApsRegisters.task.register("asr@ctc")
class CtcTask(ASRTask):
    """CTC on the encoder of a model whose forward(x_pad, x_len) gives
    (enc_out, enc_ctc, enc_len)."""

    def __init__(self, nnet: nn.Module, blank: int = 0, **kwargs):
        super(CtcTask, self).__init__(nnet, **kwargs)
        self.blank = blank

    def forward(self, egs: Dict) -> Dict:
        _, ctc_enc, enc_len = self.nnet(egs["src_pad"], egs["src_len"])
        loss = ctc_objf(ctc_enc, egs["tgt_pad"], enc_len, egs["tgt_len"],
                        blank=self.blank, reduction=self.reduction,
                        add_softmax=True)
        return {"loss": loss}


@ApsRegisters.task.register("asr@ctc_xent")
class CtcXentHybridTask(ASRTask):
    """CTC on the encoder + label-smoothed Xent on the decoder."""

    def __init__(self,
                 nnet: nn.Module,
                 blank: int = 0,
                 lsm_factor: float = 0,
                 lsm_method: str = "uniform",
                 ctc_weight: float = 0,
                 label_count: str = "",
                 **kwargs):
        super(CtcXentHybridTask, self).__init__(nnet, **kwargs)
        if lsm_method == "unigram" and not label_count:
            raise RuntimeError("Missing label_count for unigram smoothing")
        self.blank = blank
        self.lsm_factor = lsm_factor
        self.lsm_method = lsm_method
        self.ctc_weight = ctc_weight
        self.label_count = load_label_count(label_count)

    def forward(self, egs: Dict) -> Dict:
        tgt_infer, tgt_refer = prep_asr_label(egs["tgt_pad"],
                                              egs["tgt_len"],
                                              self.nnet.eos,
                                              sos_value=self.nnet.sos,
                                              eos_value=self.nnet.eos)
        outs, ctc_enc, enc_len = self.nnet(egs["src_pad"], egs["src_len"],
                                           tgt_infer, egs["tgt_len"] + 1,
                                           ssr=egs.get("#ssr", 0))
        if self.lsm_factor > 0:
            att_loss = ls_objf(outs, tgt_refer, method=self.lsm_method,
                               reduction=self.reduction,
                               lsm_factor=self.lsm_factor,
                               label_count=self.label_count)
        else:
            att_loss = ce_objf(outs, tgt_refer, reduction=self.reduction)
        stats = {}
        ctc_loss = 0
        if self.ctc_weight > 0:
            ctc_loss = ctc_objf(ctc_enc, egs["tgt_pad"], enc_len,
                                egs["tgt_len"], blank=self.blank,
                                reduction=self.reduction, add_softmax=True)
            stats["@ctc"] = ctc_loss
            stats["xent"] = att_loss
        stats["accu"] = compute_accu(outs, tgt_refer)[0]
        stats["loss"] = self.ctc_weight * ctc_loss + \
            (1 - self.ctc_weight) * att_loss
        return stats


@ApsRegisters.task.register("asr@transducer")
class TransducerTask(ASRTask):
    """The RNN-T objective (aps_tpu_torch/ops/rnnt.py) of a transducer
    model: its blank (vocab_size - 1, injected by load_am_conf) prefixes
    the targets, which stand in for <ignore> too; the loss summed over the
    batch, divided by the target tokens (mean) or the utterances
    (batchmean)."""

    def __init__(self, nnet: nn.Module, blank: int = 0,
                 interface: str = "torch", **kwargs):
        # interface names aps_tpu's loss implementation; there is one here
        super(TransducerTask, self).__init__(nnet, **kwargs)
        self.blank = blank

    def forward(self, egs: Dict) -> Dict:
        tgt_infer, _ = prep_asr_label(egs["tgt_pad"], egs["tgt_len"],
                                      self.blank, sos_value=self.blank,
                                      eos_value=self.blank)
        _, dec_out, enc_len = self.nnet(egs["src_pad"], egs["src_len"],
                                        tgt_infer, egs["tgt_len"] + 1)
        tgts = egs["tgt_pad"].masked_fill(egs["tgt_pad"] == IGNORE_ID,
                                          self.blank)
        loss = rnnt_loss(dec_out, tgts, enc_len, egs["tgt_len"],
                         blank=self.blank, reduction="sum")
        denorm = egs["tgt_len"].sum() if self.reduction == "mean" else \
            dec_out.shape[0]
        return {"loss": loss / denorm}


@ApsRegisters.task.register("asr@lm")
class LmXentTask(ASRTask):
    """LM cross-entropy over egs {src, tgt, len} (the lm@utt and lm@bptt
    loaders' batches) -> {accu, loss, @ppl}; the trainer's report takes
    exp of @ppl.

    bptt_mode reads the LM's state from egs["hidden"], as aps_tpu does; but
    no loader sets that key (lm@bptt yields "reset" only), so in aps_tpu
    and here no state is carried from one BPTT window to the next: every
    window starts from the zero state."""

    def __init__(self, nnet: nn.Module, bptt_mode: bool = False, **kwargs):
        super(LmXentTask, self).__init__(nnet, **kwargs)
        self.bptt_mode = bptt_mode

    def forward(self, egs: Dict) -> Dict:
        hidden = egs.get("hidden", None) if self.bptt_mode else None
        pred, _ = self.nnet(egs["src"], hidden, egs.get("len", None))
        loss = ce_objf(pred, egs["tgt"], reduction=self.reduction)
        accu, den = compute_accu(pred, egs["tgt"])
        ppl = loss if self.reduction == "mean" else \
            loss * pred.shape[0] / den
        return {"accu": accu, "loss": loss, "@ppl": ppl}
