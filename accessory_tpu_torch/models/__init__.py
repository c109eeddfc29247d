"""Model registry: llama_type -> model module, every type of the JAX
package's registry (the PEFT and sparse Mixtral variants, every llama_ens
variant and both SPHINX-MoE types share a module, as in the JAX package)."""

from __future__ import annotations

import importlib

_MODULES = {"llama": "accessory_tpu_torch.models.llama",
            "llama_peft": "accessory_tpu_torch.models.llama",
            "llama_adapter": "accessory_tpu_torch.models.llama_adapter",
            "internlm": "accessory_tpu_torch.models.internlm",
            "falcon": "accessory_tpu_torch.models.falcon",
            "mixtral": "accessory_tpu_torch.models.mixtral",
            "mixtral_peft": "accessory_tpu_torch.models.mixtral",
            "mixtral_sparse": "accessory_tpu_torch.models.mixtral",
            "llama_qformerv2": "accessory_tpu_torch.models.llama_qformerv2",
            "llama_qformerv2_peft": "accessory_tpu_torch.models.llama_qformerv2",
            "mixtral_sparse_ens": "accessory_tpu_torch.models.sphinx_moe",
            "mixtral_sparse_ens5": "accessory_tpu_torch.models.sphinx_moe",
            **{t: "accessory_tpu_torch.models.sphinx"
               for t in ("llama_ens", "llama_ens5", "llama_ens5p2", "llama_ens10",
                         "llama_ens_peft", "llama_ens_light", "llama_ens5_light")}}


def get_model_module(llama_type: str):
    if llama_type not in _MODULES:
        raise KeyError(f"unknown llama_type {llama_type!r} (known: {sorted(_MODULES)})")
    return importlib.import_module(_MODULES[llama_type])
