"""Interactive terminal chat with one model or several side by side, text or
image. Port of ``accessory_tpu/demos/cli.py``: several --pretrained_path
values make every model answer each prompt; ``--image`` (or ``/image PATH``
mid-chat) attaches an image to the next turn (PIL reads it: ``_load_image``
runs where PIL is installed); ``/reset`` clears the history; an empty line
quits.

    python -m accessory_tpu_torch.demos.cli --pretrained_path ckpt/ [b/ ...] [--image photo.jpg]
"""

from __future__ import annotations

import argparse


def get_args_parser():
    p = argparse.ArgumentParser("cli demo", add_help=False)
    p.add_argument("--pretrained_path", required=True, type=str, nargs="+",
                   help="one checkpoint dir per model; several = compare")
    p.add_argument("--llama_type", default=None, type=str)
    p.add_argument("--max_seq_len", default=2048, type=int)
    p.add_argument("--max_gen_len", default=256, type=int)
    p.add_argument("--temperature", default=0.1, type=float)
    p.add_argument("--top_p", default=0.75, type=float)
    p.add_argument("--quant", action="store_true")
    p.add_argument("--quant_bits", default=4, type=int, choices=(3, 4, 8))
    p.add_argument("--kv_dtype", default=None, choices=(None, "int8"),
                   help="int8: quantized KV cache (2x context per GB)")
    p.add_argument("--image", default=None, type=str,
                   help="start the session with this image attached")
    p.add_argument("--device", default="cuda", type=str)
    return p


def _load_image(path: str, model):
    """The image at ``path`` -> (1, 3, S, S) at the model's image_size
    (padded_resize)."""
    import numpy as np

    from accessory_tpu_torch.data.data_reader import read_img_general
    from accessory_tpu_torch.data.transform import get_transform

    size = getattr(model.args, "image_size", 224)
    return np.asarray(get_transform("padded_resize", size)(read_img_general(path)))[None]


def _answer(model, prompt: str, images, a, stops=()) -> str:
    shown = ""
    for chunk in model.stream_generate(prompt, images=images, max_gen_len=a.max_gen_len,
                                       temperature=a.temperature, top_p=a.top_p,
                                       additional_stop_symbols=tuple(stops)):
        text = chunk["text"]
        print(text[len(shown):], end="", flush=True)
        shown = text
        if chunk["end_of_content"]:
            break
    print()
    return shown


def main(args) -> None:
    from accessory_tpu_torch.data.conversation import default_conversation
    from accessory_tpu_torch.meta import MetaModel

    models = []
    for path in args.pretrained_path:
        m = MetaModel.from_pretrained(path, llama_type=args.llama_type,
                                      max_seq_len=args.max_seq_len, quant=args.quant,
                                      quant_bits=args.quant_bits, kv_dtype=args.kv_dtype,
                                      device=args.device)
        models.append((path, m))

    image = _load_image(args.image, models[0][1]) if args.image else None
    # per-model history: compared models build on their own answers
    qas = {path: [] for path, _ in models}
    print("(empty line to quit; '/reset' clears history; "
          "'/image <path>' attaches an image to the next turn)")
    while True:
        try:
            q = input("user: ").strip()
        except EOFError:
            break
        if not q:
            break
        if q == "/reset":
            qas = {path: [] for path, _ in models}
            image = None
            continue
        if q.startswith("/image"):
            path = q.split(None, 1)[1] if len(q.split()) > 1 else ""
            image = _load_image(path, models[0][1])
            print(f"(image attached: {path})")
            continue
        for path, model in models:
            conv = default_conversation()
            conv.load_qas(qas[path] + [[q, None]])
            label = f"[{path}] " if len(models) > 1 else ""
            print(f"{label}assistant: ", end="", flush=True)
            ans = _answer(model, conv.get_prompt(), image, args,
                          stops=(conv.response_end_signal,))
            qas[path].append([q, ans])
        image = None  # an image attaches to one turn


if __name__ == "__main__":
    main(get_args_parser().parse_args())
