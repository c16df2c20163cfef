#!/usr/bin/env python
"""Audio-chunk dataloader for enhancement / separation training (port of
aps_tpu/loader/se/chunk.py, registered "se@chunk"; same arguments and egs
contract, except that the sharding of the utterance order takes rank and
world_size explicitly). Direction-of-arrival values (doa_scp: "key float"
lines) and speaker embeddings (emb_scp: "key path.npy" lines) ride along
with each chunk of their utterance, as in aps_tpu.

The chunk starts and the shuffle of the chunk pool draw from Python's global
`random` generator, as in aps_tpu, so a seeded process gives the same
batches in both packages."""

import random
from typing import Dict, Iterable, Iterator, List, Union

import numpy as np

from aps_tpu_torch.io.audio import AudioReader
from aps_tpu_torch.io.base import BaseReader
from aps_tpu_torch.libs import ApsRegisters
from aps_tpu_torch.loader.utils import derive_indices


@ApsRegisters.loader.register("se@chunk")
def DataLoader(train: bool = True,
               rank: int = 0,
               world_size: int = 1,
               sr: int = 16000,
               mix_scp: str = "",
               doa_scp: str = "",
               ref_scp: str = "",
               emb_scp: str = "",
               chunk_size: int = 64000,
               max_batch_size: int = 16,
               num_workers: int = 4) -> Iterable[Dict]:
    """Chunked waveform loader; ref_scp and doa_scp may be comma-separated
    lists for several speakers. Egs: {mix: N x (C x) S, ref: N x S or [N x
    S, ...], doa: N or [N, ...], emb: N x E, "#utt": N}."""
    if not mix_scp:
        raise RuntimeError("mix_scp can not be None")

    def parse_args(scp_str):
        if not scp_str:
            return scp_str
        token = scp_str.split(",")
        return token[0] if len(token) == 1 else list(token)

    dataset = ScriptDataset(sr=sr, mix_scp=mix_scp, emb_scp=emb_scp,
                            doa_scp=parse_args(doa_scp),
                            ref_scp=parse_args(ref_scp))
    return WaveChunkDataLoader(dataset, train=train, chunk_size=chunk_size,
                               batch_size=max_batch_size,
                               num_workers=num_workers, rank=rank,
                               world_size=world_size)


class NumpyReader(BaseReader):
    """Reader over an scp of .npy paths."""

    def _load(self, key: str) -> np.ndarray:
        return np.load(self.index_dict[key])


class ScriptDataset(object):
    """Dataset configured by (mix, ref, doa, emb) scp files."""

    def __init__(self,
                 mix_scp: str = "",
                 doa_scp: Union[str, List[str]] = "",
                 emb_scp: str = "",
                 ref_scp: Union[str, List[str]] = "",
                 sr: int = 16000) -> None:
        self.mix = AudioReader(mix_scp, sr=sr)
        if isinstance(ref_scp, list) and ref_scp:
            self.ref = [AudioReader(ref, sr=sr) for ref in ref_scp]
            self.num_ref = len(ref_scp)
        elif ref_scp:
            self.ref = AudioReader(ref_scp, sr=sr)
            self.num_ref = 1
        else:
            self.ref, self.num_ref = None, 0
        if isinstance(doa_scp, list) and doa_scp:
            self.doa = [BaseReader(doa, value_processor=np.float32)
                        for doa in doa_scp]
            self.num_doa = len(doa_scp)
        elif doa_scp:
            self.doa = BaseReader(doa_scp, value_processor=np.float32)
            self.num_doa = 1
        else:
            self.doa, self.num_doa = None, 0
        self.emb = NumpyReader(emb_scp) if emb_scp else None

    def _idx(self, key: str) -> Dict:
        eg = {}
        if self.ref is not None:
            eg["ref"] = (self.ref[key] if self.num_ref == 1 else
                         [r[key] for r in self.ref])
        if self.doa is not None:
            eg["doa"] = (self.doa[key] if self.num_doa == 1 else
                         [r[key] for r in self.doa])
        if self.emb is not None:
            eg["emb"] = self.emb[key]
        return eg

    def __getitem__(self, index: int) -> Dict:
        key = self.mix.index_keys[index]
        eg = self._idx(key)
        eg["mix"] = self.mix[key]
        return eg

    def __len__(self) -> int:
        return len(self.mix)

    def __iter__(self) -> Iterator[Dict]:
        for key, mix in self.mix:
            eg = self._idx(key)
            eg["mix"] = mix
            yield eg


class ChunkSplitter(object):
    """Split utterances into fixed-size chunks (pad short, hop long)."""

    def __init__(self, chunk_size: int, train: bool = True,
                 hop: int = 16000) -> None:
        self.chunk_size = chunk_size
        self.hop = hop
        self.train = train

    def _chunk(self, mat_or_seq, s: int):
        if isinstance(mat_or_seq, list):
            return [m[..., s:s + self.chunk_size] for m in mat_or_seq]
        return mat_or_seq[..., s:s + self.chunk_size]

    def _pad(self, mat_or_seq, pad_width: int):

        def pad1(mat):
            widths = [(0, 0)] * (mat.ndim - 1) + [(0, pad_width)]
            return np.pad(mat, widths, "constant")

        if isinstance(mat_or_seq, list):
            return [pad1(m) for m in mat_or_seq]
        return pad1(mat_or_seq)

    def _make_chunk(self, eg: Dict, s: int) -> Dict:
        chunk = {"mix": eg["mix"][..., s:s + self.chunk_size]}
        if "ref" in eg:
            chunk["ref"] = self._chunk(eg["ref"], s)
        for k in ("doa", "emb"):
            if k in eg:
                chunk[k] = eg[k]
        return chunk

    def split(self, eg: Dict) -> List[Dict]:
        N = eg["mix"].shape[-1]
        if N < self.hop:
            return []
        chunks = []
        if N < self.chunk_size:
            P = self.chunk_size - N
            chunk = {"mix": self._pad(eg["mix"], P)}
            if "ref" in eg:
                chunk["ref"] = self._pad(eg["ref"], P)
            for k in ("doa", "emb"):
                if k in eg:
                    chunk[k] = eg[k]
            chunks.append(chunk)
        else:
            s = random.randint(0, N % self.hop) if self.train else 0
            while s + self.chunk_size <= N:
                chunks.append(self._make_chunk(eg, s))
                s += self.hop
        return chunks


def _default_collate(chunks: List[Dict]) -> Dict:
    """Stack a list of chunk dicts into batched numpy arrays: float32 for
    arrays and lists of them, a plain array for scalars (doa)."""
    out = {}
    peek = chunks[0]
    for k in peek:
        if isinstance(peek[k], list):
            out[k] = [
                np.stack([np.asarray(c[k][i]) for c in chunks]).astype(
                    np.float32) for i in range(len(peek[k]))
            ]
        elif isinstance(peek[k], np.ndarray):
            out[k] = np.stack([c[k] for c in chunks]).astype(np.float32)
        else:
            out[k] = np.asarray([c[k] for c in chunks])
    return out


class WaveChunkDataLoader(object):
    """Chunk-splitting dataloader: iterates utterances (rank-sharded and
    epoch-shuffled), splits into fixed chunks, emits full batches; what is
    left of the chunk pool at the end of an epoch is dropped. Its length is
    not known ahead and reads 0, as in aps_tpu. A dataset item may be one
    egs dict or a list of them (se@config's on-the-fly mixtures)."""

    def __init__(self,
                 dataset,
                 num_workers: int = 4,
                 chunk_size: int = 64000,
                 batch_size: int = 16,
                 train: bool = True,
                 rank: int = 0,
                 world_size: int = 1) -> None:
        self.dataset = dataset
        self.train = train
        self.batch_size = batch_size
        self.rank, self.world_size = rank, world_size
        self.splitter = ChunkSplitter(chunk_size, train=train,
                                      hop=chunk_size // 2)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return 0

    def _utt_indices(self) -> List[int]:
        return derive_indices(len(self.dataset) // self.world_size,
                              seed=self.epoch, shuffle=self.train,
                              rank=self.rank, world_size=self.world_size)

    def __iter__(self) -> Iterator[Dict]:
        chunk_list = []
        for idx in self._utt_indices():
            eg = self.dataset[idx]
            for sub in (eg if isinstance(eg, list) else [eg]):
                chunk_list += self.splitter.split(sub)
            while len(chunk_list) >= self.batch_size:
                if self.train:
                    random.shuffle(chunk_list)
                batch, chunk_list = (chunk_list[:self.batch_size],
                                     chunk_list[self.batch_size:])
                obj = _default_collate(batch)
                obj["#utt"] = self.batch_size
                yield obj
