#!/usr/bin/env python
"""Command-driven online simulation loader for AM training (port of
aps_tpu/loader/am/simu_cmd.py, registered "am@simu_cmd"; same arguments
and egs contract, except that the sharding of the batch order takes rank
and world_size explicitly). The mixture of each utterance is simulated
when it is read, from its line of simu_cfg; utt2dur is in seconds."""

from typing import Dict, Iterable, Optional

import numpy as np

from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.loader.am.utils import CommonASRDataLoader, CommonASRDataset
from aps_tpu_torch.loader.se.simu_cmd import CommandOptionsDataset


class SimuCmdReader(CommandOptionsDataset):
    """Simulated-mixture reader keyed like an AudioReader."""

    def __init__(self, simu_cfg: str) -> None:
        super(SimuCmdReader, self).__init__(simu_cfg, return_in_egs=["mix"])

    def __getitem__(self, key) -> np.ndarray:
        # keyed access (CommonASRDataset passes utterance keys)
        if isinstance(key, str):
            return self._simu(self.simu_cfg[key])["mix"]
        return self._simu(self.simu_cfg[self.simu_cfg.index_keys[key]])["mix"]


@ApsRegisters.loader.register("am@simu_cmd")
def DataLoader(train: bool = True,
               rank: int = 0,
               world_size: int = 1,
               simu_cfg: str = "",
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
    """Simulated waveform dataloader for AM training: egs["src_pad"] is N x
    (C) x S float32, padded as am@raw's."""
    dataset = CommonASRDataset(SimuCmdReader(simu_cfg),
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
