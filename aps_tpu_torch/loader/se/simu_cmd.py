#!/usr/bin/env python
"""Command-driven online simulation loader for SSE (port of
aps_tpu/loader/se/simu_cmd.py, registered "se@simu_cmd"; same arguments
and egs contract, except that the sharding of the utterance order takes
rank and world_size explicitly).

Each line of simu_cfg is "<key> <options of loader/simu.py>"; every item
is simulated when it is read (loader.simu.run_simu, numpy's global draws
none: the options fix the mixture), and the port's WaveChunkDataLoader
cuts the mixtures into chunks with Python's `random`, as in aps_tpu."""

from typing import Dict, Iterable, Iterator, List

from aps_tpu_torch.io.base import BaseReader
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.loader.se.chunk import WaveChunkDataLoader
from aps_tpu_torch.loader.simu import make_argparse, run_simu


@ApsRegisters.loader.register("se@simu_cmd")
def DataLoader(train: bool = True,
               rank: int = 0,
               world_size: int = 1,
               sr: int = 16000,
               simu_cfg: str = "",
               noise_label: bool = False,
               chunk_size: int = 64000,
               max_batch_size: int = 16,
               num_workers: int = 4) -> Iterable[Dict]:
    """simu_cfg lines: "<key> <command options of loader/simu.py>"; with
    noise_label the noise is the last reference."""
    dataset = CommandOptionsDataset(
        simu_cfg,
        return_in_egs=["mix", "ref", "noise"] if noise_label else
        ["mix", "ref"])
    return WaveChunkDataLoader(dataset,
                               train=train,
                               chunk_size=chunk_size,
                               batch_size=max_batch_size,
                               num_workers=num_workers,
                               rank=rank,
                               world_size=world_size)


class CommandOptionsDataset(object):
    """Dataset driven by per-utterance simulation command lines."""

    def __init__(self, simu_cfg: str,
                 return_in_egs: List[str] = ["mix"]) -> None:
        self.simu_cfg = BaseReader(simu_cfg, num_tokens=-1)
        self.parser = make_argparse()
        self.return_in_egs = return_in_egs

    def _simu(self, opts_str) -> Dict:
        args = self.parser.parse_args(opts_str)
        mix, spk_ref, noise = run_simu(args)
        egs = {"mix": mix}
        if "noise" in self.return_in_egs and noise is not None:
            spk_ref.append(noise)
        if "ref" in self.return_in_egs:
            egs["ref"] = spk_ref[0] if len(spk_ref) == 1 else spk_ref
        return egs

    def __getitem__(self, index: int) -> Dict:
        key = self.simu_cfg.index_keys[index]
        return self._simu(self.simu_cfg[key])

    def __len__(self) -> int:
        return len(self.simu_cfg)

    def __iter__(self) -> Iterator[Dict]:
        for _, opts_str in self.simu_cfg:
            yield self._simu(opts_str)
