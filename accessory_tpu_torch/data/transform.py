"""Image transforms (PIL + numpy) with CLIP normalization. Own copy of
``accessory_tpu/data/transform.py``: random_resized_crop (training),
resized_center_crop (evaluation), padded_resize (pad to a square with the
CLIP mean colour, then resize: SPHINX's inference transform). Output: f32
CHW numpy, CLIP-normalized.

PIL is imported inside the functions that take an image, so the module
imports where PIL is not installed (the card's machine has none).
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
PAD_FILL = tuple(int(255 * x) for x in CLIP_MEAN)  # mean-colour padding


def _to_chw_normalized(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)


def resized_center_crop(img, size: int) -> np.ndarray:
    from PIL import Image

    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(size, round(w * scale)), max(size, round(h * scale))),
                     Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return _to_chw_normalized(img)


def random_resized_crop(img, size: int, scale: Tuple[float, float] = (0.9, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                        rng: random.Random | None = None) -> np.ndarray:
    from PIL import Image

    rng = rng or random
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            img = img.crop((left, top, left + cw, top + ch)).resize((size, size), Image.BICUBIC)
            return _to_chw_normalized(img)
    return resized_center_crop(img, size)


def padded_resize(img, size: int) -> np.ndarray:
    """Pad to a square with the CLIP mean colour, then resize (bicubic)."""
    from PIL import Image

    w, h = img.size
    side = max(w, h)
    canvas = Image.new("RGB", (side, side), PAD_FILL)
    canvas.paste(img.convert("RGB"), ((side - w) // 2, (side - h) // 2))
    return _to_chw_normalized(canvas.resize((size, size), Image.BICUBIC))


def get_transform(name: str, size: int):
    if name == "random_resized_crop":
        return lambda img: random_resized_crop(img, size)
    if name == "resized_center_crop":
        return lambda img: resized_center_crop(img, size)
    if name == "padded_resize":
        return lambda img: padded_resize(img, size)
    raise ValueError(name)
