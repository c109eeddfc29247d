"""SPHINX's user-facing API. Port of ``accessory_tpu/sphinx_api.py``:
``SPHINXModel.generate_response(qas, image)`` (the conversation template,
the image padded to a square and resized to the model's image_size, stop
at the response separator) and ``batch_caption``, the batched captioning
workload (one prompt for every image, ``batch_size`` images a generate
call).

An image is a PIL image (``data.transform.padded_resize``, which needs
PIL) or an array / tensor already transformed: (3, S, S) CLIP-normalized at
the model's image_size.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from accessory_tpu_torch.data.conversation import default_conversation
from accessory_tpu_torch.meta import MetaModel


def _pixels(image, size: int):
    if isinstance(image, (np.ndarray, torch.Tensor)):
        if tuple(image.shape) != (3, size, size):
            raise ValueError(f"image array of shape {tuple(image.shape)}: the model takes "
                             f"(3, {size}, {size}) CLIP-normalized")
        return image
    from accessory_tpu_torch.data.transform import padded_resize

    return padded_resize(image, size)


def _stack(images):
    if isinstance(images[0], torch.Tensor):
        return torch.stack(list(images))
    return np.stack([np.asarray(x) for x in images])


class SPHINXModel(MetaModel):
    def generate_response(self, qas: List[List[Optional[str]]], image=None,
                          max_gen_len: int = 512, temperature: float = 0.0, top_p: float = 0.95,
                          seed: int = 0) -> str:
        """qas: [[q1, a1], ..., [qN, None]], the last answer None; returns the
        model's answer to qN."""
        if not qas or qas[-1][1] is not None:
            raise ValueError("the last answer of qas must be None")
        conv = default_conversation()
        conv.load_qas(qas)
        images = None
        if image is not None:
            images = _stack([_pixels(image, getattr(self.args, "image_size", 224))])
        out = self.generate([conv.get_prompt()], images=images, max_gen_len=max_gen_len,
                            temperature=temperature, top_p=top_p,
                            additional_stop_symbols=(conv.response_end_signal,), seed=seed)[0]
        end = conv.response_end_signal
        if end and end in out:
            out = out[:out.index(end)]
        return out.strip()


def batch_caption(model: MetaModel, images, prompt: str = "Describe the image.",
                  batch_size: int = 8, **gen_kwargs) -> List[str]:
    """One caption an image: ``prompt`` in the conversation template with
    each image, ``batch_size`` images a generate call."""
    conv = default_conversation()
    conv.load_qas([[prompt, None]])
    text = conv.get_prompt()
    size = getattr(model.args, "image_size", 224)
    outs: List[str] = []
    for i in range(0, len(images), batch_size):
        chunk = _stack([_pixels(x, size) for x in images[i:i + batch_size]])
        res = model.generate([text] * len(chunk), images=chunk,
                             additional_stop_symbols=(conv.response_end_signal,), **gen_kwargs)
        outs.extend(r.split(conv.response_end_signal)[0].strip() for r in res)
    return outs
