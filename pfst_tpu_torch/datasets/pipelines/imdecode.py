"""Decode an image file by its magic bytes, not its extension: PNG
(``pipelines/png.py``) or TIFF (``pipelines/tiff.py``), in cv2's
conventions; any other format raises ``UnsupportedImage``."""
from __future__ import annotations

from .png import SIGNATURE, UnsupportedImage, read_png
from .tiff import MAGIC, read_tiff


def read_image(path: str, mode: str = 'color'):
    """``path`` decoded as ``cv2.imread`` would in ``mode`` ('color',
    'grayscale' or 'unchanged')."""
    with open(path, 'rb') as f:
        head = f.read(8)
    if head == SIGNATURE:
        return read_png(path, mode)
    if head[:4] in MAGIC:
        return read_tiff(path, mode)
    raise UnsupportedImage(
        f'{path}: neither a PNG nor a TIFF file. The port decodes PNGs and '
        f'baseline TIFFs; pack other images with tools/pack_dataset.py '
        f'where cv2 is installed (the packs of tools/pack_dataset.py and '
        f'tools/pack_dataset_torch.py are read by both packages)')
