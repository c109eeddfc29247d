"""Dialog templates and the multi-turn finetune dataset.

Port of ``accessory_tpu/data/conversation.py``: SeparatorStyle,
Conversation, the templates and their registry (which the server's ``/chat``
route renders prompts with), and the dialog finetune dataset:
``ConversationGenerator`` renders a dialog through a template,
``FinetuneDialogDataset`` tokenizes it and labels each assistant reply,
found by tokenizing the reply as a segment and locating it
(``find_sublist``), on the annotations and type groups of
``data/alpaca.py::FinetuneDataset``. An item with nothing to predict or a
reply not found falls back to the item before it; one whose labels are all
masked raises ``LabelAllZeroError``, which ``__getitem__`` answers with a
neighbour of the same group. Outputs are numpy."""

from __future__ import annotations

import dataclasses
import json
import traceback
import warnings
from enum import Enum, auto
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

IGNORE_INDEX = -1


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()


@dataclasses.dataclass
class Conversation:
    """Conversation template; ``process`` renders the full dialog text and
    collects the assistant spans a model learns to predict."""

    system: str
    roles: Tuple[str, str]
    messages: List
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None

    def process(self) -> Dict:
        to_predict: List[str] = []
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + "\n\n" + self.sep
            for i, (role, message) in enumerate(self.messages):
                if message is not None:
                    ret += " " + role + ": " + message + "\n" + self.sep
                    if role == self.roles[1]:
                        to_predict.append(message + "\n" + self.sep)
                else:
                    if i != len(self.messages) - 1:
                        raise ValueError("only the last message can be None")
                    ret += " " + role + ":"
        elif self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += " " + role + ": " + message + seps[i % 2]
                    if role == self.roles[1]:
                        to_predict.append(message + seps[i % 2])
                else:
                    if i != len(self.messages) - 1:
                        raise ValueError("only the last message can be empty")
                    ret += " " + role + ":"
        else:
            raise ValueError(self.sep_style)
        return {"conv": ret, "to_predict": to_predict}

    def get_prompt(self) -> str:
        return self.process()["conv"]

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles, [[r, m] for r, m in self.messages],
                            self.sep_style, self.sep, self.sep2)

    def load_qas(self, qas: List[List[Optional[str]]]) -> None:
        self.messages = []
        for q, a in qas:
            self.append_message(self.roles[0], q)
            self.append_message(self.roles[1], a)

    @property
    def response_end_signal(self) -> str:
        return "\n" + self.sep if self.sep_style == SeparatorStyle.SINGLE else self.sep2


def conv_v1() -> Conversation:
    return Conversation(
        system="A chat between a curious human and an artificial intelligence assistant. "
               "The assistant gives helpful, detailed, and polite answers to the human's questions.",
        roles=("Human", "Assistant"), messages=[],
        sep_style=SeparatorStyle.SINGLE, sep="###")


def conv_vicuna_v1_1() -> Conversation:
    return Conversation(
        system="A chat between a curious user and an artificial intelligence assistant. "
               "The assistant gives helpful, detailed, and polite answers to the user's questions.",
        roles=("USER", "ASSISTANT"), messages=[],
        sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")


def conv_bair_v1() -> Conversation:
    return Conversation(
        system="BEGINNING OF CONVERSATION:", roles=("USER", "GPT"),
        messages=[], sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")


def simple_conv_multimodal() -> Conversation:
    return Conversation(
        system="You are LLaVA, a large language and vision assistant trained by UW Madison WAIV Lab."
               "You are able to understand the visual content that the user provides, and assist "
               "the user with a variety of tasks using natural language."
               "Follow the instructions carefully and explain your answers in detail.",
        roles=("Human", "Assistant"), messages=[],
        sep_style=SeparatorStyle.SINGLE, sep="###")


def conv_llava_v1() -> Conversation:
    return Conversation(
        system="You are LLaVA, a large language and vision assistant trained by UW Madison WAIV Lab."
               "You are able to understand the visual content that the user provides, and assist "
               "the user with a variety of tasks using natural language."
               "Follow the instructions carefully and explain your answers in detail.",
        roles=("USER", "ASSISTANT"), messages=[],
        sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")


CONV_TEMPLATES: Dict[str, Callable[[], Conversation]] = {
    "default": conv_v1,
    "v1": conv_v1,
    "simple": conv_v1,
    "multimodal": simple_conv_multimodal,
    "llava_v1": conv_llava_v1,
    "bair_v1": conv_bair_v1,
    "vicuna_v1_1": conv_vicuna_v1_1,
}
default_conversation = conv_v1


class LabelAllZeroError(Exception):
    pass


class ConversationGenerator:
    """A dialog's turns rendered through a template: (the text, the
    assistant replies to predict)."""

    def __init__(self, tokenizer, conv_template_func=default_conversation):
        self.tokenizer = tokenizer
        self.conv_func = conv_template_func

    def add_speaker_and_signal(self, source: List[Dict]) -> Tuple[str, List[str]]:
        conv = self.conv_func()
        for sentence in source:
            frm = sentence["from"].lower()
            if frm == "human":
                role = conv.roles[0]
            elif frm in ("gpt", "assistant"):
                role = conv.roles[1]
            else:
                raise ValueError(f"unknown dialog role: {frm}")
            conv.append_message(role, sentence["value"])
        processed = conv.process()
        return processed["conv"], processed["to_predict"]


def find_sublist(a: list, b: list) -> int:
    """The first index of ``b`` as a contiguous run in ``a``, or -1."""
    la, lb = len(a), len(b)
    for i in range(la - lb + 1):
        if a[i:i + lb] == b:
            return i
    return -1


class FinetuneDialogDataset:
    """Multi-turn dialog finetune dataset over the annotation loading and
    grouping of ``FinetuneDataset`` (items carry "conversations": a list of
    {"from": "human" | "gpt" | "assistant", "value"})."""

    def __init__(self, config_path: str, transform=None, max_words: int = 30,
                 image_words: int = 257, tokenizer=None,
                 conv_template_func=default_conversation,
                 cache_on_disk: bool = False, rank: int = 0):
        from accessory_tpu_torch.data.alpaca import FinetuneDataset

        inner = FinetuneDataset(config_path, transform=None, max_words=max_words,
                                image_words=image_words, tokenizer=tokenizer,
                                cache_on_disk=cache_on_disk, rank=rank)
        self.ann = inner.ann
        self.group_indices = inner.group_indices
        self.cache_on_disk = cache_on_disk
        self.transform = transform
        self.max_words = max_words
        self.image_words = image_words
        self.tokenizer = tokenizer
        self.conversation_generator = ConversationGenerator(tokenizer, conv_template_func)

    def __len__(self) -> int:
        return len(self.ann)

    def get_item_func(self, index: int):
        """(tokens, labels, tokens mask) as numpy, and the image for an item
        with one (the transform's output, or its RGB pixels as an array), whose
        text then has ``max_words - image_words`` positions."""
        item = self.ann[index]
        if self.cache_on_disk:
            item = json.loads(item)
        image = None
        if "image" in item:
            from accessory_tpu_torch.data.alpaca import _require
            from accessory_tpu_torch.data.data_reader import read_img_general

            _require("PIL", "items with an image")
            image = read_img_general(item["image"])
            image = self.transform(image) if self.transform else np.asarray(image)

        source = [dict(s, value=s["value"].replace("<image>", "").strip())
                  for s in item["conversations"]]
        conversation, to_predict = self.conversation_generator.add_speaker_and_signal(source)
        if not to_predict:
            warnings.warn(f"dialog with nothing to predict: {item}")
            return self[index - 1]

        tokens = self.tokenizer.encode(conversation, bos=True, eos=True)
        labels = [IGNORE_INDEX] * len(tokens)
        # each reply, tokenized as a segment, located after the previous one
        check_pos = 0
        for value in to_predict:
            tv = self.tokenizer.encode_segment(value)
            pos = find_sublist(tokens[check_pos:], tv)
            if pos == -1:
                warnings.warn("assistant reply mismatches the conversation tokens")
                return self[index - 1]
            pos += check_pos
            labels[pos: pos + len(tv)] = tv
            check_pos = pos + len(tv)

        max_words = self.max_words - (self.image_words if image is not None else 0)
        tokens = np.asarray(tokens[:max_words], np.int32)
        labels = np.asarray(labels[:max_words], np.int32)
        pad = max_words - len(tokens)
        if pad > 0:
            tokens = np.concatenate([tokens, np.full(pad, -1, np.int32)])
            labels = np.concatenate([labels, np.full(pad, -1, np.int32)])
        tokens_mask = tokens >= 0
        labels = np.where(labels >= 0, labels, 0)
        tokens = np.where(tokens_mask, tokens, 0)
        if np.count_nonzero(labels) == 0:
            raise LabelAllZeroError()
        if image is None:
            return tokens, labels, tokens_mask.astype(np.float32)
        return tokens, labels, tokens_mask.astype(np.float32), image

    def __getitem__(self, index: int):
        try:
            return self.get_item_func(index)
        except Exception as e:
            if not isinstance(e, LabelAllZeroError):
                warnings.warn(f"item {index} errored: {traceback.format_exc()}")
            # a neighbour within the same group
            for indices in self.group_indices.values():
                if indices[0] <= index <= indices[-1]:
                    return self[indices[-1] if index == indices[0] else index - 1]
            raise

    def groups(self) -> List[List[int]]:
        return list(self.group_indices.values())
