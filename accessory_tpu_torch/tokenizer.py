"""Tokenizer: dual backend with segment-retokenization probing.

Own copy of ``accessory_tpu/tokenizer.py`` (the port imports nothing of the
JAX package). Backends, tried by file type: ``tokenizer.json`` through the
HF ``tokenizers`` library, a directory through transformers' AutoTokenizer,
``*.model`` through sentencepiece; each library is imported only when its
backend is used. Tokenization runs on the host.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional


class Tokenizer:
    def __init__(self, model_path: str):
        """model_path: a ``tokenizer.json`` file, a sentencepiece ``*.model``
        file, or a directory containing HF tokenizer files."""
        if model_path.endswith(".model"):
            try:
                from sentencepiece import SentencePieceProcessor
            except ImportError as e:  # pragma: no cover - env without spm
                raise ImportError(
                    "sentencepiece is unavailable in this environment; convert "
                    "the tokenizer to tokenizer.json (HF `tokenizers`) format"
                ) from e
            self.backend = "spm"
            assert os.path.isfile(model_path), model_path
            self._tk = SentencePieceProcessor(model_file=model_path)
            self.bos_id: int = self._tk.bos_id()
            self.eos_id: int = self._tk.eos_id()
            self._n_words = self._tk.vocab_size()
        elif model_path.endswith(".json"):
            from tokenizers import Tokenizer as HFTokenizer

            self.backend = "tokenizers"
            self._tk = HFTokenizer.from_file(model_path)
            self.bos_id = self._special_id(("<s>", "<|begin_of_text|>", "<bos>"))
            self.eos_id = self._special_id(("</s>", "<|end_of_text|>", "<eos>", "<|endoftext|>"))
            if self.bos_id is None:
                self.bos_id = self.eos_id
            assert self.eos_id is not None, "tokenizer.json has no EOS token"
            self._n_words = self._tk.get_vocab_size()
        else:
            from transformers import AutoTokenizer

            self.backend = "transformers"
            self._tk = AutoTokenizer.from_pretrained(model_path, trust_remote_code=True)
            self.bos_id = self._tk.bos_token_id
            if self.bos_id is None:
                self.bos_id = self._tk.eos_token_id
            self.eos_id = self._tk.eos_token_id
            assert self.eos_id is not None
            self._n_words = len(self._tk)

        self._probe_tokenizer_style()

    def _special_id(self, candidates) -> Optional[int]:
        for tok in candidates:
            i = self._tk.token_to_id(tok)
            if i is not None:
                return i
        return None

    # -- core ---------------------------------------------------------------

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        assert isinstance(s, str)
        if self.backend == "tokenizers":
            t = self._tk.encode(s, add_special_tokens=False).ids
        elif self.backend == "transformers":
            t = self._tk.encode(s, truncation=False, add_special_tokens=False)
        else:
            t = self._tk.encode(s)
        if bos:
            t = [self.bos_id] + t
        if eos:
            t = t + [self.eos_id]
        return t

    def decode(self, t: List[int]) -> str:
        return self._tk.decode(list(t))

    # -- segment re-tokenization (reference tokenizer.py:64-112) ------------

    def encode_segment(self, s: str) -> List[int]:
        """Encode a segment cut from a longer text such that the ids match
        the corresponding slice of the full text's encoding."""
        s = s.lstrip(" ")
        if self.need_space_before_segment:
            return self.encode(" " + s, bos=False, eos=False)
        return self.encode(s, bos=False, eos=False)

    def encode_wo_prefix_space(self, s: str) -> List[int]:
        if self.need_space_before_segment:
            return self.encode(s, bos=False, eos=False)
        # find a prefix char that tokenizes independently, encode with it,
        # then strip it — defeats the implicit leading-space merge
        for prefix in ["@", "\n", "\\", "=", ">", "`"]:
            prefix_tokens = self.encode(prefix, bos=False, eos=False)
            cat_tokens = self.encode(prefix + s, bos=False, eos=False)
            if cat_tokens[: len(prefix_tokens)] == prefix_tokens:
                return cat_tokens[len(prefix_tokens):]
        raise NotImplementedError(
            f"all probe prefixes merged into {s!r} during tokenization")

    def _probe_tokenizer_style(self) -> None:
        """Detect whether a leading space must be added when tokenizing
        segments (LLaMA-style: no; InternLM-style: yes)."""
        sentence1 = self.encode("Hi my darling", bos=False, eos=False)
        sentence2 = self.encode("my darling", bos=False, eos=False)
        if sentence1[-len(sentence2):] == sentence2:
            self.need_space_before_segment = False
        else:
            sentence3 = self.encode(" my darling", bos=False, eos=False)
            assert sentence1[-len(sentence3):] == sentence3
            self.need_space_before_segment = True

    # -- persistence --------------------------------------------------------

    def save(self, save_dir: str) -> None:
        os.makedirs(save_dir, exist_ok=True)
        if self.backend == "tokenizers":
            self._tk.save(str(Path(save_dir) / "tokenizer.json"))
            cfg = Path(save_dir) / "tokenizer_config.json"
            if not cfg.exists():
                cfg.write_text('{"tokenizer_class": "PreTrainedTokenizerFast"}\n')
        elif self.backend == "transformers":
            self._tk.save_pretrained(save_dir)
        else:
            with open(Path(save_dir) / "tokenizer.model", "wb") as f:
                f.write(self._tk.serialized_model_proto())

    @property
    def n_words(self) -> int:
        return self._n_words


def probe_tokenizer_path_from_pretrained(pretrained_path: str) -> Optional[str]:
    """Find tokenizer files in a checkpoint dir.

    Reference: accessory/model/tokenizer.py:136-156. Order: tokenizer.model
    (spm) → tokenizer.json (+ tokenizer_config.json) → None.
    """
    p = Path(pretrained_path)
    if (p / "tokenizer.model").exists():
        return str(p / "tokenizer.model")
    if (p / "tokenizer.json").exists():
        # our Tokenizer loads tokenizer.json directly via the `tokenizers`
        # backend — faster and independent of tokenizer_config completeness
        return str(p / "tokenizer.json")
    if (p / "tokenizer_config.json").exists():
        return str(p)  # transformers-style directory
    return None
