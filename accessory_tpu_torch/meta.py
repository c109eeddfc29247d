"""MetaModel facade over the port. Port of ``accessory_tpu/meta.py``
(``__init__``, ``get_quant_blocklist``, ``quantize``, ``generate``,
``stream_generate``, ``compute_logits``, ``evaluate_examples``,
``save_pretrained``, ``from_pretrained``) for every family of the JAX
package's registry (LLaMA, LLaMA-Adapter, InternLM, Falcon, Mixtral, the
SPHINX and SPHINX-MoE families). A SPHINX or SPHINX-MoE family's args take
its ``visual`` and ``image_size`` defaults unless the config names them,
and its model has ``with_visual`` set: the Generator then gets the
module's ``encode_image`` as its image hook. LLaMA-Adapter has no
``encode_image``, so it generates text only, as in the JAX package (its
params carry no visual branch here either). A checkpoint directory
written by either package's ``save_pretrained`` loads in the other, and a
directory of the reference's PyTorch ``consolidated.*`` shards loads too
(``checkpoint.torch_import``)."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from accessory_tpu_torch.config import (ARGS_REGISTRY, SphinxArgs, SphinxMoEArgs,
                                        _sphinx_image_size_for, _sphinx_visual_for, make_args,
                                        union_merge_configs)
from accessory_tpu_torch.engine.generate import Generator, image_tensor
from accessory_tpu_torch.models import get_model_module
from accessory_tpu_torch.tokenizer import Tokenizer, probe_tokenizer_path_from_pretrained


class MetaModel:
    def __init__(self, llama_type: str,
                 llama_config: Union[str, Sequence[Union[str, Dict[str, Any]]]] = (),
                 tokenizer_path: Optional[str] = None, max_seq_len: int = 4096,
                 seed: int = 0, init_params: bool = True, device="cuda", tokenizer=None,
                 with_visual: bool = False, compiled: bool = True):
        """``tokenizer``: a tokenizer object to use as it is, in place of one
        loaded from ``tokenizer_path`` (the config then keeps its vocab_size).
        ``with_visual``: serve images (always on for the SPHINX and SPHINX-MoE
        families). ``compiled``: the Generator replays its decode steps as
        CUDA graphs on the card (False: runs them eagerly, the counterpart of
        ``jax.disable_jit()``)."""
        if isinstance(llama_config, (str, dict)):
            llama_config = [llama_config]
        self.llama_type = llama_type
        self.module = get_model_module(llama_type)
        self.device = device
        self.tokenizer = Tokenizer(tokenizer_path) if tokenizer_path else tokenizer
        overrides: Dict[str, Any] = {"max_seq_len": max_seq_len}
        if tokenizer_path:
            overrides["vocab_size"] = self.tokenizer.n_words
        args_cls = ARGS_REGISTRY[llama_type]
        if args_cls in (SphinxArgs, SphinxMoEArgs):
            merged = union_merge_configs(llama_config)
            if "visual" not in merged:
                overrides["visual"] = _sphinx_visual_for(llama_type)
            if "image_size" not in merged:
                overrides["image_size"] = _sphinx_image_size_for(llama_type)
            with_visual = True
        self.args = make_args(args_cls, llama_config, **overrides)
        self.with_visual = with_visual
        self.params = (self.module.init_params(self.args, seed=seed, device=device)
                       if init_params else None)
        # KV-cache dtype the Generator allocates (None: the activation dtype,
        # "int8": the int8 cache); set it, then call _reset_generator
        self.kv_dtype: Optional[str] = None
        # whether a decode step's FFN takes the fused kernel where the weights
        # allow it (the reference's ACCESSORY_FFN_FUSE=1); set it, then call
        # _reset_generator
        self.ffn_fuse = False
        self.compiled = bool(compiled)
        self._generator: Optional[Generator] = None

    @property
    def generator(self) -> Generator:
        if self._generator is None:
            if self.params is None or self.tokenizer is None:
                raise RuntimeError("MetaModel.generate needs params and a tokenizer")
            self._generator = Generator(self.module, self.args, self.params, self.tokenizer,
                                        kv_dtype=self.kv_dtype, device=self.device,
                                        ffn_fuse=self.ffn_fuse,
                                        encode_image=self._encode_image_hook(),
                                        compiled=self.compiled)
        return self._generator

    def _encode_image_hook(self):
        """(params, images) -> image words (b, n, dim) for the Generator,
        where the family has a visual branch; images (b, 3, S, S) CLIP-
        normalized, numpy or torch."""
        enc = getattr(self.module, "encode_image", None)
        if not self.with_visual or enc is None:
            return None

        def f(params, images):
            return enc(params, self.args, image_tensor(images, self.device))

        return f

    def _reset_generator(self):
        self._generator = None

    def generate(self, prompts: List[str], images=None, max_gen_len: int = 512,
                 temperature: float = 0.0, top_p: float = 0.95,
                 additional_stop_symbols: Iterable[str] = (), seed: int = 0) -> List[str]:
        return self.generator.generate(prompts, images=images, max_gen_len=max_gen_len,
                                       temperature=temperature, top_p=top_p,
                                       additional_stop_symbols=additional_stop_symbols,
                                       seed=seed)

    def stream_generate(self, prompt: str, images=None, max_gen_len: int = 512,
                        temperature: float = 0.0, top_p: float = 0.95,
                        additional_stop_symbols: Iterable[str] = (), seed: int = 0):
        return self.generator.stream_generate(prompt, images=images, max_gen_len=max_gen_len,
                                              temperature=temperature, top_p=top_p,
                                              additional_stop_symbols=additional_stop_symbols,
                                              seed=seed)

    def compute_logits(self, examples, images=None):
        return self.generator.compute_logits(examples, images)

    def evaluate_examples(self, contexts, continuations, images=None, batch_size: int = 8):
        return self.generator.evaluate_examples(contexts, continuations, images=images,
                                                batch_size=batch_size)

    def get_quant_blocklist(self) -> List[str]:
        """Model-specific path substrings never quantized (the module's
        ``get_quant_blocklist``, none for LLaMA)."""
        fn = getattr(self.module, "get_quant_blocklist", None)
        return list(fn(self.args)) if fn else []

    def quantize(self, bits: int = 4, group_size: int = 128):
        """Quantize the dense weights to W``bits`` (3, 4 or 8) in the layout
        ``quantize_params`` picks for it, keeping dense every path on the
        default blocklist or the model's own (``get_quant_blocklist``)."""
        from accessory_tpu_torch.quant.quantize import DEFAULT_BLOCKLIST, quantize_params

        block = tuple(DEFAULT_BLOCKLIST) + tuple(self.get_quant_blocklist())
        kw = dict(bits=bits, group_size=group_size, blocklist=block)
        layers = self.params.get("layers")
        if isinstance(layers, list):
            # one layer at a time, each replacing its dense weights, so the
            # dense and the quantized model never both sit in device memory
            rest = {k: v for k, v in self.params.items() if k != "layers"}
            self.params = dict(quantize_params(rest, **kw), layers=layers)
            for i in range(len(layers)):
                layers[i] = quantize_params(layers[i], **kw)
        else:
            self.params = quantize_params(self.params, **kw)
        self._reset_generator()
        return self

    def save_pretrained(self, save_dir: str) -> None:
        """Self-describing checkpoint dir: weights (+ quant.json), config.json,
        meta.json and, where the tokenizer has files of its own, the tokenizer."""
        from accessory_tpu_torch.checkpoint import save_checkpoint

        os.makedirs(save_dir, exist_ok=True)
        save_checkpoint(save_dir, self.params)
        with open(Path(save_dir) / "config.json", "w") as f:
            json.dump(dataclasses.asdict(self.args), f, indent=2)
        with open(Path(save_dir) / "meta.json", "w") as f:
            json.dump({"llama_type": self.llama_type}, f, indent=2)
        if hasattr(self.tokenizer, "save"):
            self.tokenizer.save(save_dir)

    @classmethod
    def from_pretrained(cls, pretrained_path: Union[str, Sequence[str]],
                        llama_type: Optional[str] = None,
                        llama_config: Optional[Sequence[str]] = None,
                        tokenizer_path: Optional[str] = None, max_seq_len: int = 4096,
                        quant: bool = False, quant_bits: int = 4,
                        kv_dtype: Optional[str] = None, dtype: str = "bfloat16",
                        device="cuda", tokenizer=None, ffn_fuse: bool = False,
                        with_visual: bool = False, compiled: bool = True) -> "MetaModel":
        """Probe a checkpoint dir for meta.json / config.json / tokenizer and
        load its weights onto ``device`` tensor by tensor. ``pretrained_path``
        may be a list: later entries override / add. ``quant`` quantizes the
        dense weights after loading (a checkpoint that is already quantized
        stays as it is); ``kv_dtype`` is the KV-cache dtype the Generator
        allocates; ``ffn_fuse`` runs each decode step's FFN as one fused
        kernel where the weights allow it (off by default, as the reference's
        ``ACCESSORY_FFN_FUSE``); ``dtype`` casts dense floating weights;
        ``tokenizer``: a tokenizer object that takes the place of the probed
        tokenizer file. A path may be a native checkpoint dir or a dir of
        the reference's ``consolidated.*`` shards (a ``*-diff`` dir adds its
        deltas to the paths before it). ``compiled``: as in ``MetaModel``. A SPHINX family's ``visual`` subtree
        keeps its stored f32 whatever ``dtype`` says."""
        paths = [pretrained_path] if isinstance(pretrained_path, str) else list(pretrained_path)
        root = paths[-1]
        if llama_type is None:
            meta_file = Path(root) / "meta.json"
            if not meta_file.exists():
                raise FileNotFoundError(f"no meta.json under {root}; pass llama_type")
            llama_type = json.loads(meta_file.read_text())["llama_type"]
        if llama_config is None:
            cfg = Path(root) / "config.json"
            llama_config = [str(cfg)] if cfg.exists() else []
        if tokenizer_path is None and tokenizer is None:
            for p in reversed(paths):
                tokenizer_path = probe_tokenizer_path_from_pretrained(p)
                if tokenizer_path:
                    break
            if not tokenizer_path:
                raise FileNotFoundError(f"no tokenizer found under {paths}")

        from accessory_tpu_torch.checkpoint import load_checkpoint_list

        model = cls(llama_type, list(llama_config), tokenizer_path, max_seq_len=max_seq_len,
                    init_params=False, device=device, tokenizer=tokenizer,
                    with_visual=with_visual, compiled=compiled)
        model.params = load_checkpoint_list(paths, dtype=dtype, args=model.args, device=device)
        missing = [k for k in model.module.TOP_LEVEL_KEYS if k not in model.params]
        if missing:
            raise KeyError(f"the checkpoints under {paths} hold no {missing}: a partial "
                           "checkpoint loads after the base weights it extends")
        if quant:
            model.quantize(bits=quant_bits)
        model.kv_dtype = kv_dtype
        model.ffn_fuse = ffn_fuse
        model._reset_generator()
        return model
