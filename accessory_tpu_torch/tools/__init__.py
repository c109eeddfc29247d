"""CLI tools of the port: packed pretraining data (``generate_packed_data``).
Port of ``accessory_tpu/tools``; its other tools (weight deltas, the HF
export and download) are not ported."""
