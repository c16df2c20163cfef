#!/usr/bin/env python
"""Kaldi-feature AM dataloader (port of aps_tpu/loader/am/kaldi.py,
registered "am@kaldi"; same arguments and egs contract, except that the
sharding of the batch order takes rank and world_size explicitly).

Reads feats.scp through the port's kaldi_io.ScriptReader; utt2num_frames
counts feature frames, and egs["src_pad"] is N x T x F float32, the time
axis padded up to aps_tpu's length grid (quantize_len(n, floor=50,
multiple=8, factor=1.2))."""

from typing import Dict, Iterable, List, Optional

import numpy as np

from aps_tpu_torch.const import IGNORE_ID
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.loader.am.utils import CommonASRDataLoader, CommonASRDataset
from aps_tpu_torch.loader.kaldi_io import ScriptReader
from aps_tpu_torch.loader.utils import pad_seqs, quantize_len


def feature_collate(egs: List[Dict]) -> Dict:
    """Collate T x F feature egs: src padded on axis 0 (time) up to
    quantize_len(n, floor=50, multiple=8, factor=1.2), tgt on its own axis
    up to a multiple of 8 with IGNORE_ID."""
    src = [np.asarray(eg["inp"], dtype=np.float32) for eg in egs]
    tgt = [np.asarray(eg["ref"], dtype=np.int64) for eg in egs]
    return {
        "#utt": len(egs),
        "#tok": sum(int(eg["len"]) + 1 for eg in egs),
        "src_pad": pad_seqs(
            src, value=0, axis=0,
            len_quantize=lambda n: quantize_len(n, floor=50, multiple=8,
                                                factor=1.2)),
        "tgt_pad": pad_seqs(
            tgt, value=IGNORE_ID, axis=-1,
            len_quantize=lambda n: quantize_len(n, multiple=8, factor=1.0)),
        "src_len": np.asarray([eg["dur"] for eg in egs], dtype=np.int64),
        "tgt_len": np.asarray([eg["len"] for eg in egs], dtype=np.int64),
    }


@ApsRegisters.loader.register("am@kaldi")
def DataLoader(train: bool = True,
               rank: int = 0,
               world_size: int = 1,
               feats_scp: str = "",
               text: str = "",
               utt2num_frames: str = "",
               vocab_dict: Optional[Dict] = None,
               tokenizer: str = "",
               tokenizer_kwargs: Dict = {},
               min_token_num: int = 1,
               max_token_num: int = 400,
               max_dur: float = 3000,
               min_dur: float = 40,
               adapt_dur: float = 800,
               adapt_token_num: int = 150,
               skip_utts: str = "",
               batch_mode: str = "adaptive",
               num_workers: int = 0,
               max_batch_size: int = 32,
               min_batch_size: int = 4) -> Iterable[Dict]:
    """Feature dataloader for AM training: utt2num_frames and the duration
    limits count frames."""
    dataset = CommonASRDataset(ScriptReader(feats_scp),
                               text,
                               utt2num_frames,
                               vocab_dict,
                               tokenizer=tokenizer,
                               tokenizer_kwargs=tokenizer_kwargs,
                               max_dur=max_dur,
                               min_dur=min_dur,
                               dur_axis=0,
                               skip_utts=skip_utts,
                               min_token_num=min_token_num,
                               max_token_num=max_token_num)
    return CommonASRDataLoader(dataset,
                               collate_fn=feature_collate,
                               shuffle=train,
                               rank=rank,
                               world_size=world_size,
                               num_workers=num_workers,
                               adapt_dur=adapt_dur,
                               adapt_token_num=adapt_token_num,
                               batch_mode=batch_mode,
                               max_batch_size=max_batch_size,
                               min_batch_size=min_batch_size)
