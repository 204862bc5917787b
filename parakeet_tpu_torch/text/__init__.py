from parakeet_tpu_torch.text.tokenizer import Tokenizer

__all__ = ["Tokenizer"]
