"""Dialog templates. Own copy of the framework-free part of
``accessory_tpu/data/conversation.py`` (SeparatorStyle, Conversation, the
templates and their registry up to ``default_conversation``), which the
server's ``/chat`` route renders prompts with. The finetune dataset classes
below it in the reference wait for the training slice of the port."""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import Callable, Dict, List, Optional, Tuple


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
