"""The port's ``read_image`` against the JAX package's (OpenCV) on TIFF
tiles: equal shape, dtype and every sample.

OpenCV writes most layouts itself (compression 1, 5, 8, 32946, 32773;
Predictor 1, 2 and 3; RowsPerStrip 1, 2, odd and whole; u8 and u16; 1, 3
and 4 samples; every sample type the port stitches: int8, int16, int32,
uint32, float32 and float64). Tiles, big-endian files, BigTIFF,
PlanarConfiguration 2 and declared alpha are built with
``torch_tile_files`` and read back by OpenCV as the oracle.
PlanarConfiguration 2 is taken for 8-bit samples: OpenCV 5.0 reads those,
and reads 16-bit planes as if they were interleaved, so the port raises
there instead.
"""

import cv2
import numpy as np
import pytest

import torch_tiff_samples
from torch_tile_files import tiff_bytes
from image_stitcher_tpu.io.acquisition import read_image as jax_read_image
from image_stitcher_tpu_torch.io.acquisition import read_image
from image_stitcher_tpu_torch.io.tiff import decode_tiff

COMPRESSIONS = [1, 5, 8, 32946, 32773]


def _pred(comp):
    """Predictor 2 where libtiff applies it (LZW, deflate), else 1."""
    return 2 if comp in (5, 8, 32946) else 1


def _image(seed, dtype, spp, h=37, w=53):
    rng = np.random.default_rng(seed)
    shape = (h, w) if spp == 1 else (h, w, spp)
    return rng.integers(0, np.iinfo(dtype).max, shape,
                        dtype=np.uint32).astype(dtype)


def _assert_same(path):
    want = jax_read_image(path)
    got = read_image(path)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


def _write(tmp_path, data, name="A1_0_0_ch.tiff"):
    path = str(tmp_path / name)
    with open(path, 'wb') as f:
        f.write(data)
    return path


@pytest.mark.parametrize("comp", COMPRESSIONS)
@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=['u8', 'u16'])
@pytest.mark.parametrize("spp", [1, 3, 4])
def test_opencv_written_tiff(tmp_path, comp, predictor, dtype, spp):
    img = _image(comp + spp, dtype, spp)
    path = str(tmp_path / "A1_0_0_ch.tiff")
    assert cv2.imwrite(path, img, [
        int(cv2.IMWRITE_TIFF_COMPRESSION), comp,
        int(cv2.IMWRITE_TIFF_PREDICTOR), predictor,
        int(cv2.IMWRITE_TIFF_ROWSPERSTRIP), 5])
    if comp == 1 and spp == 4:
        # the JAX fast path keeps the alpha plane of an uncompressed RGBA
        # tile (a reference fault, ROADMAP section 3); the port drops it
        want = jax_read_image(path)
        np.testing.assert_array_equal(read_image(path), want[:, :, :3])
        return
    got = _assert_same(path)
    assert got.shape[:2] == img.shape[:2]


@pytest.mark.parametrize("rows_per_strip", [1, 2, 7, 37, 1000],
                         ids=['1', '2', 'odd', 'whole', 'past_end'])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=['u8', 'u16'])
def test_rows_per_strip(tmp_path, rows_per_strip, dtype):
    img = _image(rows_per_strip, dtype, 1)
    path = str(tmp_path / "t.tiff")
    assert cv2.imwrite(path, img, [int(cv2.IMWRITE_TIFF_ROWSPERSTRIP),
                                   rows_per_strip])     # LZW + predictor
    np.testing.assert_array_equal(_assert_same(path), img)


def test_opencv_default_writer_is_lzw_with_predictor(tmp_path):
    """What ``cv2.imwrite('x.tiff', u16)`` writes (Compression 5,
    Predictor 2, 2-row strips at 2048 wide) decodes equal."""
    img = _image(9, np.uint16, 1, h=64, w=2048)
    path = str(tmp_path / "t.tiff")
    assert cv2.imwrite(path, img)
    from image_stitcher_tpu_torch.io.tiff import read_ifd
    with open(path, 'rb') as f:
        _, tags = read_ifd(f.read())
    assert tags[259] == (5,) and tags[317] == (2,) and tags[278] == (2,)
    np.testing.assert_array_equal(_assert_same(path), img)


@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=['u8', 'u16'])
@pytest.mark.parametrize("spp", [1, 3, 4])
def test_tiled(tmp_path, comp, dtype, spp):
    """Tiles overhanging the right and bottom edges are cropped."""
    img = _image(comp * spp, dtype, spp, h=45, w=70)
    path = _write(tmp_path, tiff_bytes(img, comp, _pred(comp),
                                       tile=(32, 16)))
    got = _assert_same(path)
    np.testing.assert_array_equal(got, img[..., :3] if spp == 4 else img)


@pytest.mark.parametrize("byteorder", ['<', '>'], ids=['II', 'MM'])
@pytest.mark.parametrize("bigtiff", [False, True], ids=['classic', 'big'])
@pytest.mark.parametrize("comp", [1, 5, 8, 32773])
@pytest.mark.parametrize("layout", ['strips', 'tiles'])
def test_byte_order_and_bigtiff(tmp_path, byteorder, bigtiff, comp, layout):
    img = _image(3, np.uint16, 3, h=40, w=48)
    kw = dict(tile=(16, 16)) if layout == 'tiles' else dict(rows_per_strip=3)
    path = _write(tmp_path, tiff_bytes(img, comp, _pred(comp),
                                       byteorder=byteorder, bigtiff=bigtiff,
                                       **kw))
    np.testing.assert_array_equal(_assert_same(path), img)


@pytest.mark.parametrize("comp", [1, 5, 8])
@pytest.mark.parametrize("spp", [3, 4])
@pytest.mark.parametrize("layout", ['strips', 'tiles'])
def test_planar_separate_8bit(tmp_path, comp, spp, layout):
    img = _image(spp, np.uint8, spp, h=33, w=40)
    kw = dict(tile=(16, 16)) if layout == 'tiles' else dict(rows_per_strip=4)
    path = _write(tmp_path, tiff_bytes(img, comp, _pred(comp), planar=2,
                                       **kw))
    np.testing.assert_array_equal(_assert_same(path), img[..., :3])


def test_planar_separate_16bit_is_refused(tmp_path):
    """OpenCV 5.0 reads 16-bit planes as if they were interleaved (a wrong
    array); the port raises instead. One plane (spp 1) is unaffected."""
    img = _image(4, np.uint16, 3)
    path = _write(tmp_path, tiff_bytes(img, 5, 1, planar=2))
    assert not np.array_equal(jax_read_image(path), img)
    with pytest.raises(NotImplementedError, match="item 6"):
        read_image(path)
    gray = _image(4, np.uint16, 1)
    path = _write(tmp_path, tiff_bytes(gray, 5, 1, planar=2), "g.tiff")
    np.testing.assert_array_equal(_assert_same(path), gray)


@pytest.mark.parametrize("extra", [0, 1, 2],
                         ids=['unspecified', 'associated', 'unassociated'])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16], ids=['u8', 'u16'])
def test_declared_alpha(tmp_path, extra, dtype):
    """OpenCV premultiplies unassociated 8-bit alpha (libtiff's RGBA
    reader) and reads the rest as stored; the port gives what it gives."""
    img = _image(extra, dtype, 4)
    path = _write(tmp_path, tiff_bytes(img, 5, 2, rows_per_strip=8,
                                       extra_samples=[extra]))
    _assert_same(path)


def test_magic_bytes_not_suffix(tmp_path):
    """A TIFF whose name does not say so is read as TIFF; a name ending in
    'tif' without a dot takes no fast path but decodes the same."""
    img = _image(5, np.uint16, 1)
    data = tiff_bytes(img, 5, 2, rows_per_strip=4)
    for name in ("A1_0_0_ch.png", "A1_0_0_chtif", "A1_0_0_ch.bmp"):
        np.testing.assert_array_equal(
            _assert_same(_write(tmp_path, data, name)), img)


@pytest.mark.parametrize("what", ['jpeg', 'float', 'old_lzw', 'palette',
                                  'bits12', 'half'])
def test_out_of_scope_raises_naming_an_item(tmp_path, what):
    img = _image(6, np.uint8, 1, h=16, w=16)
    if what == 'jpeg':
        path = str(tmp_path / "t.tiff")
        assert cv2.imwrite(path, img, [int(cv2.IMWRITE_TIFF_COMPRESSION), 7])
        item = "item 19"
    else:
        # LZW: the fast path (which reads raw samples whatever the tags
        # say, as the JAX one does) declines the file
        data = bytearray(tiff_bytes(img.astype(np.uint16) if what == 'half'
                                    else img, 5, 1))
        if what == 'old_lzw':
            data[8:8 + 2] = b'\x00\x01'     # the strip: LSB-first ClearCode
        else:
            tag, value = {'float': (339, 3), 'palette': (262, 3),
                          'bits12': (258, 12), 'half': (339, 3)}[what]
            ifd = int.from_bytes(data[4:8], 'little')
            n = int.from_bytes(data[ifd:ifd + 2], 'little')
            for i in range(n):
                e = ifd + 2 + 12 * i
                if int.from_bytes(data[e:e + 2], 'little') == tag:
                    data[e + 8:e + 10] = value.to_bytes(2, 'little')
        path = _write(tmp_path, bytes(data), "t.tif")
        item = "item 6"
    with pytest.raises(NotImplementedError, match=item):
        read_image(path)


def test_corrupt_file_raises_value_error_naming_it(tmp_path):
    img = _image(7, np.uint16, 1)
    data = bytearray(tiff_bytes(img, 8, 2, rows_per_strip=8))
    data[20:60] = bytes(40)          # inside the first deflate strip
    path = _write(tmp_path, bytes(data), "bad.tiff")
    with pytest.raises(ValueError, match="bad.tiff"):
        read_image(path)


# --------------------------------------------------------- sample types

SAMPLE_TYPES = ['uint8', 'int8', 'uint16', 'int16', 'int32', 'uint32',
                'float32', 'float64']
#: (compression, Predictor): what OpenCV 5.0 writes on request. LZW with
#: Predictor 2 is its default for integers, deflate with Predictor 3 (the
#: floating-point predictor) is libtiff's for floats; Predictor 3 takes
#: float samples only.
CODECS = [(1, 1), (5, 1), (5, 2), (8, 2), (32946, 1), (32773, 1), (5, 3),
          (8, 3)]


def _typed_image(seed, dtype, spp, h=37, w=53):
    """Values over the whole range of an integer type; floats with
    fractions, signs, zeros and both infinities."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if spp == 1 else (h, w, spp)
    dtype = np.dtype(dtype)
    if dtype.kind == 'f':
        img = (rng.standard_normal(shape) * 1e4).astype(dtype)
        img.reshape(-1)[:4] = [0.0, -0.0, np.inf, -np.inf]
        return img
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


def _opencv_cases():
    for dtype in SAMPLE_TYPES:
        for comp, pred in CODECS:
            if pred != 3 or dtype.startswith('float'):
                yield dtype, comp, pred


@pytest.mark.parametrize("spp", [1, 3])
@pytest.mark.parametrize("dtype,comp,pred", list(_opencv_cases()))
def test_opencv_encoded_sample_types(tmp_path, dtype, comp, pred, spp):
    """Every sample type and codec OpenCV writes: ``read_image`` equals
    ``cv2.imdecode`` of the same bytes (and the JAX package's reader), and
    the plain decoders equal the C ones."""
    img = _typed_image(comp + pred + spp, dtype, spp)
    ok, buf = cv2.imencode('.tiff', img, [
        int(cv2.IMWRITE_TIFF_COMPRESSION), comp,
        int(cv2.IMWRITE_TIFF_PREDICTOR), pred,
        int(cv2.IMWRITE_TIFF_ROWSPERSTRIP), 4])
    assert ok
    want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)    # BGR, as written
    np.testing.assert_array_equal(want, img)
    got = _assert_same(_write(tmp_path, buf.tobytes()))  # RGB
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want[:, :, ::-1] if spp == 3
                                  else want)
    assert decode_tiff(buf, plain=True).tobytes() == \
        decode_tiff(buf).tobytes()


@pytest.mark.parametrize("dtype", SAMPLE_TYPES)
def test_opencv_default_writer_on_sample_types(tmp_path, dtype):
    img = _typed_image(9, dtype, 1)
    path = str(tmp_path / "t.tiff")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(_assert_same(path), img)


def _layout_cases():
    for dtype in SAMPLE_TYPES:
        for comp in (1, 5, 8, 32773):
            for pred in (1, 2, 3):
                if (pred == 1 or comp in (5, 8)) and (
                        pred != 3 or dtype.startswith('float')):
                    yield dtype, comp, pred


@pytest.mark.parametrize("byteorder", ['<', '>'], ids=['II', 'MM'])
@pytest.mark.parametrize("layout", ['strips', 'tiles'])
@pytest.mark.parametrize("dtype,comp,pred", list(_layout_cases()))
def test_sample_types_in_every_layout(tmp_path, dtype, comp, pred, byteorder,
                                      layout):
    """Files OpenCV cannot write (big-endian, tiled) of every sample type,
    codec and predictor: the source's samples, as the JAX package reads
    them; the plain decoders equal the C ones."""
    img = _typed_image(comp * pred, dtype, 3, h=40, w=48)
    kw = dict(tile=(16, 16)) if layout == 'tiles' else dict(rows_per_strip=3)
    data = tiff_bytes(img, comp, pred, byteorder=byteorder, **kw)
    np.testing.assert_array_equal(_assert_same(_write(tmp_path, data)), img)
    assert decode_tiff(data, plain=True).tobytes() == \
        decode_tiff(data).tobytes()


def test_fp_predictor_on_integer_samples_is_corrupt(tmp_path):
    """libtiff refuses Predictor 3 on integer samples; the port raises
    ``DecodeError`` (a ``ValueError``) naming the file."""
    data = bytearray(tiff_bytes(_typed_image(1, 'uint16', 1), 8, 1))
    ifd = int.from_bytes(data[4:8], 'little')
    n = int.from_bytes(data[ifd:ifd + 2], 'little')
    entry = bytes(data[ifd + 2 + 12 * (n - 1):ifd + 2 + 12 * n])
    assert int.from_bytes(entry[:2], 'little') == 339
    # a Predictor entry (317 = 3) in place of SampleFormat's, tags sorted
    data[ifd + 2 + 12 * (n - 1):ifd + 2 + 12 * n] = (
        (317).to_bytes(2, 'little') + entry[2:8] + (3).to_bytes(2, 'little')
        + b'\0\0')
    path = _write(tmp_path, bytes(data), "p3.tiff")
    with pytest.raises(ValueError, match="p3.tiff"):
        read_image(path)


# ------------------------------------------------------------------ JPEG

@pytest.mark.parametrize("writer,sampling", [
    ('cv2', None), ('cv2', cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
    ('cv2', cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
    ('cv2', cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
    ('cv2', cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440), ('pil', None),
    ('pil', 2), ('pil', 1), ('pil', 0),
    ('cv2', cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    ('cv2-progressive', None),
    ('cv2-progressive', cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
    ('cv2-progressive', cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
    ('pil-progressive', 2), ('pil-cmyk', 0)],
    ids=['cv2-grey', 'cv2-420', 'cv2-422', 'cv2-444', 'cv2-440',
         'pil-grey', 'pil-420', 'pil-422', 'pil-444', 'cv2-411',
         'cv2-progressive-grey', 'cv2-progressive-420',
         'cv2-progressive-411', 'pil-progressive-420', 'pil-cmyk'])
@pytest.mark.parametrize("suffix", ['jpg', 'jpeg'])
def test_jpeg_tiles_read_as_jax(tmp_path, writer, sampling, suffix):
    """``.jpg``/``.jpeg`` tiles (Squid's suffixes), written by OpenCV
    (the JAX package's writer and reader) and by PIL, baseline and
    progressive, CMYK too: the port's ``read_image`` equals the JAX
    package's."""
    from PIL import Image
    rng = np.random.default_rng(sampling or 0)
    y, x = np.mgrid[:45, :67]
    base = 120 + 70 * np.sin(x / 6.0) * np.cos(y / 9.0)
    img = np.clip(base[..., None] + rng.normal(0, 15, (45, 67, 3)), 0,
                  255).astype(np.uint8)
    if sampling is None:
        img = img[..., 0]
    path = str(tmp_path / f"A1_0_0_ch.{suffix}")
    if writer.startswith('cv2'):
        params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE,
                  int(writer.endswith('progressive'))]
        if sampling is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
        assert cv2.imwrite(path, img, params)
    else:
        kw = {} if sampling is None else dict(subsampling=sampling)
        im = Image.fromarray(img)
        if writer == 'pil-cmyk':
            im, kw = im.convert('CMYK'), {}
        im.save(path, 'JPEG', quality=90,
                progressive=writer == 'pil-progressive', **kw)
    got = _assert_same(path)
    assert got.shape == img.shape


@pytest.mark.parametrize("streaming", ['off', 'on'], ids=['inram', 'band'])
def test_jpeg_acquisition_stitches_as_jax(tmp_path, streaming):
    """A 3x3 acquisition of OpenCV ``.jpg`` tiles (uint8, quality 95, as
    Squid's ``cv2.imwrite`` stores them), stitched with registration and
    flatfield by both packages: the same shifts and the same OME-Zarr
    trees (blosc-lz4 chunks byte for byte)."""
    import torch
    from fixtures import write_synthetic_acquisition
    from torch_helpers import assert_outputs_equal
    from image_stitcher_tpu import EngineOptions as JaxOptions
    from image_stitcher_tpu import stitch as jax_stitch
    import image_stitcher_tpu_torch as port
    acq = str(tmp_path / "acq")
    write_synthetic_acquisition(
        acq, grid_cols=3, grid_rows=3, tile_w=72, tile_h=64, overlap=16,
        seed=19, ext='jpg', dtype=np.uint8,
        channels=["Fluorescence 488 nm Ex", "Fluorescence 561 nm Ex"],
        acq_params_overrides={"pixel_binning": 2})
    opts = dict(streaming=streaming, chunks=(1, 1, 1, 64, 64))
    jpipe = jax_stitch(acq, use_registration=True, apply_flatfield=True,
                       options=JaxOptions(fusion_device='device',
                                          output_folder=str(tmp_path / "jax"),
                                          **opts))
    pipe = port.stitch(acq, use_registration=True, apply_flatfield=True,
                       device=torch.device('cpu'),
                       state=port.state_from_reference(
                           flatfields=jpipe.flatfields),
                       options=port.EngineOptions(
                           output_folder=str(tmp_path / "port"), **opts))
    assert pipe.shifts.h_shift == jpipe.shifts.h_shift
    assert pipe.shifts.v_shift == jpipe.shifts.v_shift
    assert_outputs_equal(str(tmp_path / "jax"), str(tmp_path / "port"))


# ------------------------------------------- the card's sample-type file

def test_kept_sample_files_are_what_the_script_writes():
    """``torch_tiff_samples.npz``, which ``chip_smoke.py`` decodes on the
    card's host (no OpenCV there), holds what ``torch_tiff_samples.make``
    writes with this host's OpenCV."""
    made = torch_tiff_samples.make()
    kept = torch_tiff_samples.load()
    assert sorted(kept) == sorted(made)
    for name in kept:
        np.testing.assert_array_equal(kept[name], made[name], name)


@pytest.mark.parametrize("name", [c[0] for c in torch_tiff_samples.cases()])
def test_kept_sample_files_decode_to_their_digests(name):
    """Each kept file decodes, through the C decoders and their plain
    versions, to the pixels whose SHA-256 it carries: OpenCV's."""
    kept = torch_tiff_samples.load()
    data, digest = kept[name], str(kept[name + ':sha256'])
    got = decode_tiff(data)
    assert torch_tiff_samples.pixel_digest(got) == digest
    assert decode_tiff(data, plain=True).tobytes() == got.tobytes()
