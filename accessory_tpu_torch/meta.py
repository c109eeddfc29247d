"""MetaModel facade over the port. Port of ``accessory_tpu/meta.py``
(``__init__``, ``quantize``, ``generate``); ``from_pretrained`` and
``save_pretrained`` come with the checkpoint reader (ROADMAP A6)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from accessory_tpu_torch.config import ARGS_REGISTRY, make_args
from accessory_tpu_torch.engine.generate import Generator
from accessory_tpu_torch.models import get_model_module
from accessory_tpu_torch.tokenizer import Tokenizer


class MetaModel:
    def __init__(self, llama_type: str,
                 llama_config: Union[str, Sequence[Union[str, Dict[str, Any]]]] = (),
                 tokenizer_path: Optional[str] = None, max_seq_len: int = 4096,
                 seed: int = 0, init_params: bool = True, device="cuda"):
        if isinstance(llama_config, (str, dict)):
            llama_config = [llama_config]
        self.llama_type = llama_type
        self.module = get_model_module(llama_type)
        self.device = device
        self.tokenizer = Tokenizer(tokenizer_path) if tokenizer_path else None
        overrides: Dict[str, Any] = {"max_seq_len": max_seq_len}
        if self.tokenizer is not None:
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
