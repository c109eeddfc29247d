"""Checkpoints: the native safetensors format shared with the JAX package."""

from accessory_tpu_torch.checkpoint.native import (flatten_params, load_checkpoint,
                                                   load_checkpoint_list, read_safetensors,
                                                   save_checkpoint, stream_checkpoint,
                                                   write_safetensors)

__all__ = ["flatten_params", "load_checkpoint", "load_checkpoint_list", "read_safetensors",
           "save_checkpoint", "stream_checkpoint", "write_safetensors"]
