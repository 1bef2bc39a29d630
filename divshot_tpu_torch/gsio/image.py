"""One entry for the port's image readers: the file's magic bytes, not its
extension, pick the reader, as Pillow's ``Image.open`` picks its plugin.

- PNG (``\\x89PNG``): ``gsio/png.read_png``;
- JPEG (``FF D8 FF``): ``gsio/jpeg.read_jpeg``;
- anything else raises ``ValueError``.

``image_size`` reads (width, height) from the PNG's IHDR chunk or the
JPEG's SOF header alone, for the pose readers' Pillow size reads
(``divshot_tpu/gsio/readers.py``).
"""

from __future__ import annotations

import numpy as np

from divshot_tpu_torch.gsio.jpeg import is_jpeg, jpeg_size, read_jpeg
from divshot_tpu_torch.gsio.png import png_size, read_png

_PNG = b"\x89PNG\r\n\x1a\n"


def read_image(path: str) -> np.ndarray:
    """-> uint8 (H, W), (H, W, 3) or (H, W, 4), as
    ``np.asarray(Image.open(path))``."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG:
        return read_png(path)
    if is_jpeg(head):
        return read_jpeg(path)
    raise ValueError(f"{path}: not a PNG or JPEG file (divshot_tpu_torch "
                     f"reads PNG and JPEG images)")


def image_size(path: str) -> tuple[int, int] | None:
    """(width, height) from the file's header; None when it is neither a
    PNG nor a JPEG."""
    return png_size(path) or jpeg_size(path)
