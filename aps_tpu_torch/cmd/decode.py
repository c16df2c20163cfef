#!/usr/bin/env python
"""ASR decoder wrapper (port of cmd/decode.py::FasterDecoder.run_batch)."""

from typing import Dict, List

from aps_tpu_torch.eval.wrapper import NnetEvaluator

beam_search_params = [
    "beam_size", "nbest", "max_len", "min_len", "len_norm", "lm_weight",
    "ctc_weight", "temperature", "len_penalty", "cov_penalty",
    "eos_threshold", "cov_threshold", "allow_partial", "end_detect",
    "approx_topk", "dtype"
]


class FasterDecoder(NnetEvaluator):
    """Batched beam-search decoder over a loaded checkpoint."""

    def __init__(self, cpt_dir: str, cpt_tag: str = "best",
                 device: str = "cuda", device_id: int = -1):
        super(FasterDecoder, self).__init__(cpt_dir, cpt_tag=cpt_tag,
                                            device=device,
                                            device_id=device_id)
        name = self.conf["nnet"]
        if name != "asr@xfmr":
            raise NotImplementedError(f"decoding {name} is not ported yet")
        from aps_tpu_torch.asr.beam_search import transformer
        self.api = transformer
        self.sos = self.conf["nnet_conf"].get("sos", -1)
        self.eos = self.conf["nnet_conf"].get("eos", -1)

    def run_batch(self, batch: List, **kwargs) -> List[List[Dict]]:
        """Decode a list of 1-D waveforms -> one nbest list each."""
        return self.api.beam_search_batch(self.nnet, batch,
                                          sos=self.sos, eos=self.eos,
                                          device=self.device, **kwargs)
