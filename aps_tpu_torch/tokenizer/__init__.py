from aps_tpu_torch.tokenizer.base import Tokenizer, TokenizerAbc

__all__ = ["Tokenizer", "TokenizerAbc"]
