"""Image reading from the local filesystem or an object store. Own copy of
``accessory_tpu/data/data_reader.py``: an ``s3://`` path needs a client
injected with ``set_s3_client``. PIL is imported at the call."""

from __future__ import annotations

from io import BytesIO

_S3_CLIENT = None


def set_s3_client(client) -> None:
    """Inject an object-store client with a ``get(path) -> bytes`` method."""
    global _S3_CLIENT
    _S3_CLIENT = client


def read_img_general(img_path: str):
    """The image at ``img_path`` as an RGB PIL image."""
    from PIL import Image

    if img_path.startswith("s3://"):
        if _S3_CLIENT is None:
            raise RuntimeError("s3:// path but no object-store client configured; call "
                               "accessory_tpu_torch.data.data_reader.set_s3_client(...) first")
        return Image.open(BytesIO(_S3_CLIENT.get(img_path))).convert("RGB")
    return Image.open(img_path).convert("RGB")
