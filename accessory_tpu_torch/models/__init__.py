"""Model registry: llama_type -> model module (LLaMA, InternLM, Falcon,
Mixtral and the SPHINX families are ported; the PEFT and sparse Mixtral
variants, and every llama_ens variant, share a module, as in the JAX
package). Not ported yet (ROADMAP A8): llama_adapter and SPHINX-MoE
(mixtral_sparse_ens*)."""

from __future__ import annotations

import importlib

_MODULES = {"llama": "accessory_tpu_torch.models.llama",
            "internlm": "accessory_tpu_torch.models.internlm",
            "falcon": "accessory_tpu_torch.models.falcon",
            "mixtral": "accessory_tpu_torch.models.mixtral",
            "mixtral_peft": "accessory_tpu_torch.models.mixtral",
            "mixtral_sparse": "accessory_tpu_torch.models.mixtral",
            "llama_qformerv2": "accessory_tpu_torch.models.llama_qformerv2",
            "llama_qformerv2_peft": "accessory_tpu_torch.models.llama_qformerv2",
            **{t: "accessory_tpu_torch.models.sphinx"
               for t in ("llama_ens", "llama_ens5", "llama_ens5p2", "llama_ens10",
                         "llama_ens_peft", "llama_ens_light", "llama_ens5_light")}}


def get_model_module(llama_type: str):
    if llama_type not in _MODULES:
        raise KeyError(f"llama_type {llama_type!r} is not ported (ported: {sorted(_MODULES)}; "
                       "llama_adapter and SPHINX-MoE are ROADMAP A8)")
    return importlib.import_module(_MODULES[llama_type])
