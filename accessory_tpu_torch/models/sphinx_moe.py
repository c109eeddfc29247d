"""SPHINX-MoE (the mixtral_sparse_ens families): SPHINX's visual ensemble on
a Mixtral sparse-MoE decoder.

Port of ``accessory_tpu/models/sphinx_moe.py`` (init_params with the towers'
subtree, get_quant_blocklist, get_trainable_params_filter, forward and the
passthroughs), composed of the port's pieces: the towers, ``encode_image``,
the word counts and the splice are ``models/sphinx.py``'s (they read only the
tower fields and ``dim``), the decoder, its caches and ``forward_paged`` are
``models/mixtral.py``'s. ``mixtral_sparse_ens`` is one 224-px view (291
words), ``mixtral_sparse_ens5`` 448 px in 5 crops (1455 words). The towers
run in f32; the image words go after the leading BOS.
"""

from __future__ import annotations

from typing import Any, Dict

from accessory_tpu_torch.config import SphinxMoEArgs
from accessory_tpu_torch.models import mixtral, sphinx

Params = Dict[str, Any]

# the towers are the host's business only through dim
encode_image = sphinx.encode_image
words_per_crop = sphinx.words_per_crop
n_crops = sphinx.n_crops
image_words = sphinx.image_words
splice = sphinx.splice

# the decoder and its caches are Mixtral's: its capability flags too
init_kv_cache = mixtral.init_kv_cache
init_paged_cache = mixtral.init_paged_cache
forward_paged = mixtral.forward_paged
SUPPORTS_UNROLLED_DECODE = mixtral.SUPPORTS_UNROLLED_DECODE
SUPPORTS_UNROLLED_PAGED = mixtral.SUPPORTS_UNROLLED_PAGED
SUPPORTS_KV_INT8 = mixtral.SUPPORTS_KV_INT8
SUPPORTS_CHUNKED_PREFILL = mixtral.SUPPORTS_CHUNKED_PREFILL
SUPPORTS_DECODE_GRAPH = mixtral.SUPPORTS_DECODE_GRAPH
TOP_LEVEL_KEYS = mixtral.TOP_LEVEL_KEYS + ("visual",)


def init_params(args: SphinxMoEArgs, seed: int = 0, device="cuda") -> Params:
    """Mixtral's params plus the f32 ``visual`` subtree (``sphinx.init_visual``,
    the JAX package's ``_sphinx_visual_init``)."""
    params = mixtral.init_params(args, seed=seed, device=device)
    params["visual"] = sphinx.init_visual(args, seed, device)
    return params


def get_quant_blocklist(args: SphinxMoEArgs):
    """Mixtral's (the f32 router) and the visual modules."""
    return list(mixtral.get_quant_blocklist(args)) + sphinx.get_quant_blocklist(args)


def get_trainable_params_filter(args: SphinxMoEArgs):
    base = mixtral.get_trainable_params_filter(args)
    return lambda name: base(name) and not name.startswith("visual/")


# Mixtral's forward with the image prefix: its keywords (moe_impl,
# with_aux_loss, remat, ...) pass through; without a cache the image
# positions' logits are dropped, the aux loss kept
forward = sphinx.forward_with(encode_image, mixtral.forward)
