"""Checkpoints: the native safetensors format shared with the JAX package,
and the import of the reference's PyTorch ``consolidated.*`` checkpoints."""

from accessory_tpu_torch.checkpoint.native import (flatten_params, load_checkpoint,
                                                   load_checkpoint_list, read_safetensors,
                                                   save_checkpoint, stream_checkpoint,
                                                   write_safetensors)
from accessory_tpu_torch.checkpoint.torch_import import (import_reference_checkpoint,
                                                         infer_checkpoint_format_and_mp_size,
                                                         load_torch_checkpoint)

__all__ = ["flatten_params", "import_reference_checkpoint",
           "infer_checkpoint_format_and_mp_size", "load_checkpoint", "load_checkpoint_list",
           "load_torch_checkpoint", "read_safetensors", "save_checkpoint", "stream_checkpoint",
           "write_safetensors"]
