"""Model registry: llama_type -> model module (LLaMA, InternLM, Falcon and
Mixtral are ported; the PEFT and sparse Mixtral variants are the same
module, as in the JAX package)."""

from __future__ import annotations

import importlib

_MODULES = {"llama": "accessory_tpu_torch.models.llama",
            "internlm": "accessory_tpu_torch.models.internlm",
            "falcon": "accessory_tpu_torch.models.falcon",
            "mixtral": "accessory_tpu_torch.models.mixtral",
            "mixtral_peft": "accessory_tpu_torch.models.mixtral",
            "mixtral_sparse": "accessory_tpu_torch.models.mixtral"}


def get_model_module(llama_type: str):
    if llama_type not in _MODULES:
        raise KeyError(f"llama_type {llama_type!r} is not ported (ported: {sorted(_MODULES)}; "
                       "the multimodal families are ROADMAP A8)")
    return importlib.import_module(_MODULES[llama_type])
