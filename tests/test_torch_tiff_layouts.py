"""The rest of ROADMAP item 6's tile input: the port's ``read_image``
against the JAX package's (OpenCV, or imageio where OpenCV returns None)
on every layout of ``torch_tiff_layouts``: TIFFs OpenCV reads through
libtiff's RGBA interface (MinIsWhite, palettes, CMYK, YCbCr, grey +
alpha, bilevel in every codec with CCITT Modified Huffman, T.4 and
T.6), 10- to 14-bit samples, FillOrder 2, old-style LZW, the TIFFs the
JAX package hands to imageio (2- and 4-bit grey, 16-bit palette and
CMYK, 3-sample CMYK, 5 samples, LZMA), and RLE and 16-bit BMPs. TIFF
layouts in strips and tiles, little- and big-endian; every file decoded
by the C decoders and by their plain versions, byte-equal. Besides,
``torch_tiff_layouts.npz``, which ``chip_smoke.py`` phase 18 decodes on
the card's host, is what its script writes, and each kept file decodes
to its digest both ways.
"""

import os

import numpy as np
import pytest

import torch_tiff_layouts as layouts
from image_stitcher_tpu_torch.io.acquisition import read_image
from image_stitcher_tpu_torch.io.bmp import decode_bmp
from image_stitcher_tpu_torch.io.tiff import decode_tiff


def _cases():
    for name in layouts.names():
        if name in layouts.TIFF_LAYOUTS:
            for variant, _ in layouts.VARIANTS:
                yield name, variant
        else:
            yield name, 'file'


def _decoder(name):
    return decode_bmp if name in layouts.BMP_LAYOUTS else decode_tiff


@pytest.mark.parametrize("name,variant", list(_cases()))
def test_layout_reads_as_the_jax_package(tmp_path, name, variant):
    data = layouts.build(name, dict(layouts.VARIANTS).get(variant))
    want = layouts.jax_pixels(data, name)
    path = str(tmp_path / ("A1_0_0_ch" + layouts.suffix(name)))
    with open(path, 'wb') as f:
        f.write(data)
    if (name, variant) in layouts.REFUSED:
        # libtiff misplaces the overhanging tile's rows: not the pixels
        img, _ = layouts.TIFF_LAYOUTS[name](layouts._rng(name))
        grey = img[..., 0] if img.dtype == np.uint8 else img[..., 0] >> 8
        if name.startswith('miniswhite'):
            grey = 255 - grey
        assert not np.array_equal(want, grey)
        with pytest.raises(NotImplementedError, match="item 6"):
            read_image(path)
        return
    got = read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    decode = _decoder(name)
    assert decode(data, plain=True).tobytes() == decode(data).tobytes()


def test_kept_layout_files_are_what_the_script_writes():
    made = layouts.make()
    kept = layouts.load()
    assert sorted(kept) == sorted(made)
    for name in kept:
        np.testing.assert_array_equal(kept[name], made[name], name)
    assert os.path.getsize(layouts.PATH) < 300_000


@pytest.mark.parametrize("name", layouts.names())
def test_kept_layout_files_decode_to_their_digests(tmp_path, name):
    """Each kept file reads, through the C decoders and their plain
    versions, to the array whose digest it carries: the JAX package's."""
    kept = layouts.load()
    data, want = kept[name].tobytes(), str(kept[name + ':sha256'])
    path = str(tmp_path / ("A1_0_0_ch" + layouts.suffix(name)))
    with open(path, 'wb') as f:
        f.write(data)
    assert layouts.digest(read_image(path)) == want
    decode = _decoder(name)
    assert decode(data, plain=True).tobytes() == decode(data).tobytes()


def test_v5_bmp_16bit_bitfields_is_refused(tmp_path):
    """OpenCV looks for a 16-bit BMP's BI_BITFIELDS masks past the header,
    so it refuses a V5 header (which holds them inside); the JAX package
    then reads the file with imageio's Pillow, which widens the 5- and
    6-bit fields by repeating their top bits, unlike OpenCV's shifts. The
    port raises naming item 6 (ROADMAP section 3)."""
    from torch_tile_files import bmp_bytes
    img = np.random.default_rng(3).integers(0, 256, (9, 13, 3)).astype(
        np.uint8)
    data = bmp_bytes(img, 16, compression=3, header=124)
    want = layouts.jax_pixels(data, 'bmp')
    assert not np.array_equal(want, img & np.array([0xF8, 0xFC, 0xF8],
                                                   np.uint8))
    path = str(tmp_path / "t.bmp")
    with open(path, 'wb') as f:
        f.write(data)
    with pytest.raises(NotImplementedError, match="item 6"):
        read_image(path)


@pytest.mark.parametrize("name", ['cmyk-u16-lzw', 'samples5-u8-lzw',
                                  'lzma-rgba-u8'])
def test_imageio_tiles_of_more_than_3_samples_fail_as_the_jax_loader(
        tmp_path, name):
    """imageio keeps every sample of the TIFFs OpenCV cannot read (16-bit
    CMYK, 5 samples, LZMA RGBA): a tile of 4 or 5 channels, which the
    scan takes for one monochrome channel and the loader cannot place.
    Both packages fail there, with the same exception class (ROADMAP
    section 3)."""
    import glob
    import torch
    from fixtures import write_synthetic_acquisition
    from image_stitcher_tpu import EngineOptions as JaxOptions
    from image_stitcher_tpu import stitch as jax_stitch
    import image_stitcher_tpu_torch as port
    from torch_tile_files import tiff_bytes
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(acq, grid_cols=2, grid_rows=1, tile_w=37,
                                tile_h=23, overlap=8,
                                acq_params_overrides={"pixel_binning": 2})
    img, kw = layouts.TIFF_LAYOUTS[name](layouts._rng(name))
    for path in glob.glob(os.path.join(acq, '0', '*.tiff')):
        with open(path, 'wb') as f:
            f.write(tiff_bytes(img, **kw))
    errors = []
    for run in (lambda: jax_stitch(acq, options=JaxOptions(
                    fusion_device='device',
                    output_folder=str(tmp_path / "jax"))),
                lambda: port.stitch(acq, device=torch.device('cpu'),
                                    options=port.EngineOptions(
                                        output_folder=str(tmp_path /
                                                          "port")))):
        with pytest.raises(Exception) as info:
            run()
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1]) is ValueError, errors
    assert all("broadcast" in str(e) for e in errors), errors
