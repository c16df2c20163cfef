#!/usr/bin/env python
"""Raw-waveform AM dataloader (port of aps_tpu/loader/am/raw.py,
registered "am@raw"; same arguments and egs contract, except that the
sharding of the batch order takes rank and world_size explicitly)."""

from typing import Dict, Iterable, Optional

from aps_tpu_torch.io.audio import AudioReader
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.loader.am.utils import CommonASRDataLoader, CommonASRDataset


@ApsRegisters.loader.register("am@raw")
def DataLoader(train: bool = True,
               rank: int = 0,
               world_size: int = 1,
               wav_scp: str = "",
               sr: int = 16000,
               channel: int = -1,
               text: str = "",
               utt2dur: str = "",
               vocab_dict: Optional[Dict] = None,
               tokenizer: str = "",
               tokenizer_kwargs: Dict = {},
               min_token_num: int = 1,
               max_token_num: int = 400,
               max_dur: float = 30,
               min_dur: float = 0.4,
               adapt_dur: float = 8,
               adapt_token_num: int = 150,
               skip_utts: str = "",
               batch_mode: str = "adaptive",
               num_workers: int = 0,
               max_batch_size: int = 32,
               min_batch_size: int = 4) -> Iterable[Dict]:
    """Raw waveform dataloader for AM training: utt2dur is in seconds here,
    egs["src_pad"] is N x (C) x S float32 in [-1, 1]."""
    audio_reader = AudioReader(wav_scp, sr=sr, channel=channel, norm=True)
    dataset = CommonASRDataset(audio_reader,
                               text,
                               utt2dur,
                               vocab_dict,
                               tokenizer=tokenizer,
                               tokenizer_kwargs=tokenizer_kwargs,
                               max_dur=max_dur,
                               min_dur=min_dur,
                               dur_axis=-1,
                               skip_utts=skip_utts,
                               min_token_num=min_token_num,
                               max_token_num=max_token_num)
    return CommonASRDataLoader(dataset,
                               shuffle=train,
                               rank=rank,
                               world_size=world_size,
                               num_workers=num_workers,
                               adapt_dur=adapt_dur,
                               adapt_token_num=adapt_token_num,
                               batch_mode=batch_mode,
                               max_batch_size=max_batch_size,
                               min_batch_size=min_batch_size)
