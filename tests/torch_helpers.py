"""Helpers shared by the port's tests: a small private disk probe, and
OME-Zarr tree and OME-TIFF file comparisons.

The port's raw writers (``direct_io='auto'``) and its 'auto' compressor
measure the output disk once per process (``io/directio.py``), 256 MB per
arm, cached under the user's home. Test modules import
:func:`small_disk_probe`, an autouse fixture that shrinks the probe to
32 MB per arm and keeps its cache in pytest's temporary directory.
"""

import json
import os

import numpy as np
import pytest

JSON_FILES = ('.zarray', '.zattrs', '.zgroup', 'zarr.json')


@pytest.fixture(autouse=True)
def small_disk_probe(tmp_path_factory, monkeypatch):
    from image_stitcher_tpu_torch.io import directio
    cache = tmp_path_factory.getbasetemp() / "torch_directio.json"
    monkeypatch.setattr(directio, "_cache_path", lambda: str(cache))
    monkeypatch.setattr(directio, "_PROBE_MB", 32)


def tree_files(root):
    """Relative paths of every file under ``root``."""
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def array_dirs(root):
    """Relative paths of the zarr arrays (v2 or v3) under ``root``."""
    out = []
    for d, _, names in os.walk(root):
        if '.zarray' in names:
            out.append(os.path.relpath(d, root))
        elif 'zarr.json' in names:
            with open(os.path.join(d, 'zarr.json')) as f:
                if json.load(f).get('node_type') == 'array':
                    out.append(os.path.relpath(d, root))
    return sorted(out)


def zarr_groups(out):
    """Relative paths of the ``*.ome.zarr`` groups of a run's output."""
    return sorted(os.path.relpath(os.path.join(d, n), out)
                  for d, names, _ in os.walk(out) for n in names
                  if n.endswith('.ome.zarr'))


def assert_outputs_equal(want_out, got_out):
    """Two runs' outputs (JAX package's, port's) hold the same OME-Zarr
    groups, each as :func:`assert_trees_equal` compares them."""
    groups = zarr_groups(want_out)
    assert groups and zarr_groups(got_out) == groups
    for rel in groups:
        assert_trees_equal(os.path.join(want_out, rel),
                           os.path.join(got_out, rel))


def tiff_outputs(out):
    """Relative paths of the ``*.ome.tiff`` files of a run's output."""
    return sorted(rel for rel in tree_files(out) if rel.endswith('.ome.tiff'))


def assert_tiff_outputs_equal(want_out, got_out, lsb=0):
    """Two runs' outputs hold the same ``*.ome.tiff`` files: byte for
    byte, or with ``lsb`` > 0 the same pages, descriptions and SubIFD
    levels, each pixel within ``lsb`` (read with the port's
    ``io/tiff.py::read_pages``)."""
    from image_stitcher_tpu_torch.io.tiff import read_pages
    files = tiff_outputs(want_out)
    assert files and tiff_outputs(got_out) == files
    for rel in files:
        with open(os.path.join(want_out, rel), 'rb') as f:
            want = f.read()
        with open(os.path.join(got_out, rel), 'rb') as f:
            got = f.read()
        if lsb == 0:
            assert got == want, rel
            continue
        want_pages, got_pages = read_pages(want), read_pages(got)
        assert len(got_pages) == len(want_pages), rel
        for (wd, wl), (gd, gl) in zip(want_pages, got_pages):
            assert gd == wd, rel
            assert [a.shape for a in gl] == [a.shape for a in wl], rel
            for a, b in zip(wl, gl):
                diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
                assert diff.max(initial=0) <= lsb, rel


def assert_trees_equal(want_root, got_root):
    """Two OME-Zarr groups (JAX package's, port's) hold the same files,
    the same parsed JSON metadata, and arrays that decode equal with
    either package's reader (tensorstore and the port's
    ``read_array``)."""
    from image_stitcher_tpu.io.zarr_store import open_zarr_array
    from image_stitcher_tpu_torch.io.zarr_store import read_array
    files = tree_files(want_root)
    assert tree_files(got_root) == files
    for rel in files:
        if os.path.basename(rel) in JSON_FILES:
            with open(os.path.join(want_root, rel)) as f:
                want = json.load(f)
            with open(os.path.join(got_root, rel)) as f:
                assert json.load(f) == want, rel
    arrays = array_dirs(want_root)
    assert arrays and array_dirs(got_root) == arrays
    for rel in arrays:
        want = np.asarray(open_zarr_array(os.path.join(want_root, rel))
                          .read().result())
        for decoded in (
                np.asarray(open_zarr_array(os.path.join(got_root, rel))
                           .read().result()),
                read_array(os.path.join(got_root, rel)),
                read_array(os.path.join(want_root, rel))):
            np.testing.assert_array_equal(decoded, want, rel)
