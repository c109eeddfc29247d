"""Model registry: llama_type -> model module (only LLaMA is ported)."""

from __future__ import annotations

import importlib

_MODULES = {"llama": "accessory_tpu_torch.models.llama"}


def get_model_module(llama_type: str):
    if llama_type not in _MODULES:
        raise KeyError(f"llama_type {llama_type!r} is not ported (ported: {sorted(_MODULES)}; "
                       "the rest of the model zoo is ROADMAP A6)")
    return importlib.import_module(_MODULES[llama_type])
