"""CLI tools of the port, host-side. Port of ``accessory_tpu/tools``: packed
pretraining data (``generate_packed_data``), weight deltas
(``weight_operate``), the HuggingFace export and import
(``convert_weights_to_hf``) and the HF snapshot download (``download``)."""
