"""Output inspection: the zarr tree of a stitched output, a comparison
of two outputs, and an 8-bit RGB debug slice.

The counterpart of the JAX package's ``utils/inspect.py``, on the port's
windowed reader (``io/zarr_store.open_array``) instead of tensorstore,
and with the debug slice written by the port's PNG encoder
(``io/png.py``) instead of OpenCV.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..io.zarr_store import open_array


def zarr_tree(path: str) -> Dict:
    """Recursive description of a zarr hierarchy (v2 or v3): groups,
    arrays, attributes."""
    node: Dict = {"path": path}
    attrs_file = os.path.join(path, ".zattrs")
    if os.path.exists(attrs_file):
        with open(attrs_file) as f:
            node["attrs"] = json.load(f)
    array_file = os.path.join(path, ".zarray")
    if os.path.exists(array_file):
        with open(array_file) as f:
            meta = json.load(f)
        node["array"] = {"shape": meta["shape"], "chunks": meta["chunks"],
                         "dtype": meta["dtype"],
                         "compressor": (meta.get("compressor") or {}).get("id")}
        return node
    v3_file = os.path.join(path, "zarr.json")
    if os.path.exists(v3_file) and "attrs" not in node:
        with open(v3_file) as f:
            meta = json.load(f)
        if meta.get("attributes"):
            node["attrs"] = meta["attributes"]
        if meta.get("node_type") == "array":
            # the READ chunk: the inner chunk of a sharded array
            chunks = meta["chunk_grid"]["configuration"]["chunk_shape"]
            comp = None
            for codec in meta.get("codecs", []):
                if codec.get("name") == "sharding_indexed":
                    cfg = codec.get("configuration", {})
                    chunks = cfg.get("chunk_shape", chunks)
                    inner = [c.get("name") for c in cfg.get("codecs", [])]
                    comp = next((n for n in inner if n != "bytes"), None)
                elif codec.get("name") != "bytes" and comp is None:
                    comp = codec.get("name")
            node["array"] = {"shape": meta["shape"], "chunks": chunks,
                             "dtype": meta["data_type"], "compressor": comp}
            return node
    children = {}
    try:
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name)
            if os.path.isdir(sub) and (
                    os.path.exists(os.path.join(sub, ".zarray"))
                    or os.path.exists(os.path.join(sub, ".zgroup"))
                    or os.path.exists(os.path.join(sub, "zarr.json"))):
                children[name] = zarr_tree(sub)
    except FileNotFoundError:
        pass
    if children:
        node["children"] = children
    return node


def format_zarr_tree(path: str) -> str:
    """The tree as text: one line a group or array, then the root's
    attributes."""
    lines: List[str] = [f"Zarr tree for: {path}"]

    def walk(node: Dict, name: str, depth: int):
        indent = "  " * depth
        if "array" in node:
            a = node["array"]
            lines.append(f"{indent}{name} {a['dtype']} {tuple(a['shape'])} "
                         f"chunks={tuple(a['chunks'])} [{a['compressor']}]")
        else:
            lines.append(f"{indent}{name}/")
        for cname, child in node.get("children", {}).items():
            walk(child, cname, depth + 1)

    tree = zarr_tree(path)
    walk(tree, os.path.basename(path.rstrip('/')), 0)
    if "attrs" in tree:
        lines.append(json.dumps(tree["attrs"], indent=2)[:2000])
    return "\n".join(lines)


def print_zarr_structure(path: str) -> None:
    print(format_zarr_tree(path))


def save_debug_slice(canvas: np.ndarray, out_path: str) -> Optional[str]:
    """Write an 8-bit RGB PNG overview of the first <= 3 channels at
    z=0, each channel min-max normalized. ``canvas`` is (C, Z, Y, X) or
    (T, C, Z, Y, X). Best effort: a failure is printed and None
    returned."""
    try:
        from ..io.png import write_rgb8
        if canvas.ndim == 5:
            canvas = canvas[0]
        channels = np.asarray(canvas[:3, 0]).astype(np.float32)  # (c, y, x)
        rgb = np.zeros((channels.shape[1], channels.shape[2], 3), np.uint8)
        for i in range(channels.shape[0]):
            lo, hi = channels[i].min(), channels[i].max()
            if hi > lo:
                rgb[..., i] = ((channels[i] - lo) * 255.0 / (hi - lo)
                               ).astype(np.uint8)
        write_rgb8(out_path, rgb)
        return out_path
    except Exception as e:
        print(f"Warning: Could not save debug image: {e}")
        return None


def _collect_arrays(node: Dict, rel: str = '') -> Dict[str, Dict]:
    """rel-path -> array descriptor for every array in a zarr_tree."""
    out: Dict[str, Dict] = {}
    if 'array' in node:
        out[rel] = node
    for name, child in node.get('children', {}).items():
        out.update(_collect_arrays(child, f"{rel}/{name}" if rel else name))
    return out


def compare_stores(path_a: str, path_b: str,
                   band_rows: int = 2048) -> Dict:
    """Compare two stitched zarr hierarchies (v2 or v3, any mix).

    Arrays pair by relative path; their content is compared in bands of
    ``band_rows`` rows read through the windowed reader, so memory stays
    at one band a side. Differences are counted, with the largest
    absolute difference.

    Returns ``{'equal': bool, 'arrays': {rel: report}, 'only_a': [...],
    'only_b': [...]}``; ``report`` gives shape or dtype mismatches, or
    ``{'mismatched': n, 'maxdiff': d, 'pixels': p}``.
    """
    trees = (_collect_arrays(zarr_tree(path_a)),
             _collect_arrays(zarr_tree(path_b)))
    only_a = sorted(set(trees[0]) - set(trees[1]))
    only_b = sorted(set(trees[1]) - set(trees[0]))
    reports: Dict[str, Dict] = {}
    equal = not only_a and not only_b
    for rel in sorted(set(trees[0]) & set(trees[1])):
        a = open_array(os.path.join(path_a, rel))
        b = open_array(os.path.join(path_b, rel))
        if tuple(a.shape) != tuple(b.shape):
            reports[rel] = {'shape_a': list(a.shape),
                            'shape_b': list(b.shape)}
            equal = False
            continue
        if a.dtype != b.dtype:
            reports[rel] = {'dtype_a': str(a.dtype), 'dtype_b': str(b.dtype)}
            equal = False
            continue
        mism = 0
        maxdiff = 0.0
        h = a.shape[-2] if a.ndim >= 2 else 1
        for y0 in range(0, max(h, 1), band_rows):
            if a.ndim >= 2:
                sel = (Ellipsis, slice(y0, min(y0 + band_rows, h)),
                       slice(None))
            else:  # 0/1-D arrays: one read
                sel = (Ellipsis,)
            band_a = a[sel]
            band_b = b[sel]
            if band_a.size == 0:
                continue
            diff = band_a != band_b
            if diff.any():
                mism += int(diff.sum())
                d = np.abs(band_a.astype(np.float64)
                           - band_b.astype(np.float64))
                maxdiff = max(maxdiff, float(d.max()))
        reports[rel] = {'mismatched': mism, 'maxdiff': maxdiff,
                        'pixels': int(np.prod(a.shape))}
        if mism:
            equal = False
    return {'equal': equal, 'arrays': reports,
            'only_a': only_a, 'only_b': only_b}


def main(argv=None) -> int:
    """``python -m image_stitcher_tpu_torch.utils.inspect PATH``: print
    the zarr tree (v2 or v3) of a stitched output, or with ``--compare
    OTHER`` compare two outputs pixel for pixel (exit 0 when equal)."""
    import argparse
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument('path', help='zarr group/array directory')
    parser.add_argument('--compare', metavar='OTHER',
                        help='second store: banded pixel + tree '
                             'comparison instead of a dump')
    parser.add_argument('--json', action='store_true',
                        help='machine-readable output instead of text')
    args = parser.parse_args(argv)
    if args.compare:
        rep = compare_stores(args.path, args.compare)
        if args.json:
            print(json.dumps(rep, indent=2))
        else:
            for rel in rep['only_a']:
                print(f"only in A: {rel}")
            for rel in rep['only_b']:
                print(f"only in B: {rel}")
            for rel, r in rep['arrays'].items():
                if 'mismatched' in r and not r['mismatched']:
                    print(f"{rel}: identical ({r['pixels']} px)")
                else:
                    print(f"{rel}: DIFFERS {r}")
            print("stores identical" if rep['equal']
                  else "stores DIFFER")
        return 0 if rep['equal'] else 1
    if args.json:
        print(json.dumps(zarr_tree(args.path), indent=2))
    else:
        print(format_zarr_tree(args.path))
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(main())
