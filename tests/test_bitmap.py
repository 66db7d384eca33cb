"""BMP writer: byte-level compatibility with src/bitmap.c:5-78."""

import struct

import numpy as np

from path_tracer_jax.utils.bitmap import bitmap_bytes, write_bitmap


def test_header_fields():
    img = np.zeros((2, 3, 3), dtype=np.uint8)
    data = bitmap_bytes(img)
    assert data[:2] == b"BM"
    file_size, reserved, offset = struct.unpack("<III", data[2:14])
    row_padding = (4 - (3 * 3) % 4) % 4  # = 3
    assert file_size == 14 + 40 + (3 * 3 + row_padding) * 2
    assert reserved == 0
    assert offset == 54
    size, w, h, planes, bpp, comp, imgsize = struct.unpack("<IiiHHII", data[14:38])
    assert (size, w, h, planes, bpp, comp) == (40, 3, 2, 1, 24, 0)
    assert imgsize == (3 * 3 + row_padding) * 2
    assert len(data) == file_size


def test_bgr_order_and_row_flip():
    img = np.zeros((2, 1, 3), dtype=np.uint8)
    img[0, 0] = [255, 0, 0]  # top row red
    img[1, 0] = [0, 0, 255]  # bottom row blue
    data = bitmap_bytes(img, y_inverted=True)
    body = data[54:]
    # BMP stores bottom row first; pixel bytes are BGR (src/bitmap.c:51-53).
    assert body[0:3] == bytes([255, 0, 0])  # blue pixel -> B=255
    stride = 4  # 3 bytes + 1 pad
    assert body[stride : stride + 3] == bytes([0, 0, 255])  # red pixel


def test_no_flip_mode():
    img = np.zeros((2, 1, 3), dtype=np.uint8)
    img[0, 0] = [1, 2, 3]
    data = bitmap_bytes(img, y_inverted=False)
    assert data[54:57] == bytes([3, 2, 1])


def test_row_padding_multiple_of_4():
    for w in range(1, 9):
        img = np.full((1, w, 3), 7, dtype=np.uint8)
        data = bitmap_bytes(img)
        assert (len(data) - 54) % 4 == 0


def test_write_roundtrip(tmp_path):
    img = np.arange(2 * 4 * 3, dtype=np.uint8).reshape(2, 4, 3)
    p = tmp_path / "out.bmp"
    write_bitmap(p, img)
    assert p.read_bytes() == bitmap_bytes(img)
