from parakeet_tpu_torch.io.safetensors import load_safetensors, save_safetensors

__all__ = ["load_safetensors", "save_safetensors"]
