"""MetaModel facade over the port. Port of ``accessory_tpu/meta.py``
(``__init__``, ``quantize``, ``generate``, ``stream_generate``,
``save_pretrained``, ``from_pretrained``). A checkpoint directory written by
either package's ``save_pretrained`` loads in the other."""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from accessory_tpu_torch.config import ARGS_REGISTRY, make_args
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.models import get_model_module
from accessory_tpu_torch.tokenizer import Tokenizer, probe_tokenizer_path_from_pretrained


class MetaModel:
    def __init__(self, llama_type: str,
                 llama_config: Union[str, Sequence[Union[str, Dict[str, Any]]]] = (),
                 tokenizer_path: Optional[str] = None, max_seq_len: int = 4096,
                 seed: int = 0, init_params: bool = True, device="cuda", tokenizer=None):
        """``tokenizer``: a tokenizer object to use as it is, in place of one
        loaded from ``tokenizer_path`` (the config then keeps its vocab_size)."""
        if isinstance(llama_config, (str, dict)):
            llama_config = [llama_config]
        self.llama_type = llama_type
        self.module = get_model_module(llama_type)
        self.device = device
        self.tokenizer = Tokenizer(tokenizer_path) if tokenizer_path else tokenizer
        overrides: Dict[str, Any] = {"max_seq_len": max_seq_len}
        if tokenizer_path:
            overrides["vocab_size"] = self.tokenizer.n_words
        self.args = make_args(ARGS_REGISTRY[llama_type], llama_config, **overrides)
        self.params = (self.module.init_params(self.args, seed=seed, device=device)
                       if init_params else None)
        # KV-cache dtype the Generator allocates (None: the activation dtype,
        # "int8": the int8 cache); set it, then call _reset_generator
        self.kv_dtype: Optional[str] = None
        self._generator: Optional[Generator] = None

    @property
    def generator(self) -> Generator:
        if self._generator is None:
            if self.params is None or self.tokenizer is None:
                raise RuntimeError("MetaModel.generate needs params and a tokenizer")
            self._generator = Generator(self.module, self.args, self.params, self.tokenizer,
                                        kv_dtype=self.kv_dtype, device=self.device)
        return self._generator

    def _reset_generator(self):
        self._generator = None

    def generate(self, prompts: List[str], max_gen_len: int = 512, temperature: float = 0.0,
                 top_p: float = 0.95, additional_stop_symbols: Iterable[str] = (),
                 seed: int = 0) -> List[str]:
        return self.generator.generate(prompts, max_gen_len=max_gen_len,
                                       temperature=temperature, top_p=top_p,
                                       additional_stop_symbols=additional_stop_symbols,
                                       seed=seed)

    def stream_generate(self, prompt: str, max_gen_len: int = 512, temperature: float = 0.0,
                        top_p: float = 0.95, additional_stop_symbols: Iterable[str] = (),
                        seed: int = 0):
        return self.generator.stream_generate(prompt, max_gen_len=max_gen_len,
                                              temperature=temperature, top_p=top_p,
                                              additional_stop_symbols=additional_stop_symbols,
                                              seed=seed)

    def quantize(self, bits: int = 4, group_size: int = 128):
        from accessory_tpu_torch.quant.quantize import DEFAULT_BLOCKLIST, quantize_params

        kw = dict(bits=bits, group_size=group_size, blocklist=DEFAULT_BLOCKLIST)
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
                        device="cuda", tokenizer=None) -> "MetaModel":
        """Probe a checkpoint dir for meta.json / config.json / tokenizer and
        load its weights onto ``device`` tensor by tensor. ``pretrained_path``
        may be a list: later entries override / add. ``quant`` quantizes the
        dense weights after loading (a checkpoint that is already quantized
        stays as it is); ``kv_dtype`` is the KV-cache dtype the Generator
        allocates; ``dtype`` casts dense floating weights; ``tokenizer``: a
        tokenizer object that takes the place of the probed tokenizer file."""
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
                    init_params=False, device=device, tokenizer=tokenizer)
        model.params = load_checkpoint_list(paths, dtype=dtype, args=model.args, device=device)
        missing = [k for k in ("tok_embeddings", "layers", "norm", "output")
                   if k not in model.params]
        if missing:
            raise KeyError(f"the checkpoints under {paths} hold no {missing}: a partial "
                           "checkpoint loads after the base weights it extends")
        if quant:
            model.quantize(bits=quant_bits)
        model.kv_dtype = kv_dtype
        model._reset_generator()
        return model
