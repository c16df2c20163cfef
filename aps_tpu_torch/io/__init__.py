from aps_tpu_torch.io.audio import (AudioReader, SegmentAudioReader,
                                    group_segments, read_audio, write_audio)
from aps_tpu_torch.io.base import BaseReader
from aps_tpu_torch.io.text import NbestReader, TextReader, io_wrapper

__all__ = [
    "AudioReader", "SegmentAudioReader", "group_segments", "read_audio",
    "write_audio", "BaseReader", "NbestReader", "TextReader", "io_wrapper"
]
