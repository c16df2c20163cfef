from aps_tpu_torch.io.audio import AudioReader, read_audio, write_audio
from aps_tpu_torch.io.base import BaseReader
from aps_tpu_torch.io.text import TextReader, io_wrapper

__all__ = [
    "AudioReader", "read_audio", "write_audio", "BaseReader", "TextReader",
    "io_wrapper"
]
