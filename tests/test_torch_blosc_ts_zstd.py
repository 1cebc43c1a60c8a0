"""The port's blosc zstd chunks against tensorstore's: every
clevel of {0, 1, 5, 9}, shuffle of {0, 1, 2, -1} and u8/u16, as
``torch_blosc_matrix.check`` sets out (decoded equal both ways, the
same headers and files, C frames byte-equal to the plain version's);
at clevel 1, 5 and 9, and at clevel 2, 3, 4, 6, 7 and 8 beside them,
whole frames byte-equal to tensorstore's (libzstd 1.5.7's levels 1, 3,
5, 7, 9, 11, 13, 15 and 22: two zstd blocks a 256 KiB blosc block at
clevel 4 and 5, four a 512 KiB one at clevel 6 to 8, eight a 1 MiB one
at clevel 9)."""

import pytest

from torch_blosc_matrix import CLEVELS, DTYPES, SHUFFLES, check


@pytest.mark.parametrize("dtype", DTYPES, ids=['u8', 'u16'])
@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("clevel", CLEVELS)
@pytest.mark.parametrize("cname", ('zstd',))
def test_matches_tensorstore(tmp_path, cname, clevel, shuffle, dtype):
    check(tmp_path, cname, clevel, shuffle, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=['u8', 'u16'])
@pytest.mark.parametrize("shuffle", SHUFFLES)
def test_zstd_clevel_2_matches_tensorstore(tmp_path, shuffle, dtype):
    check(tmp_path, 'zstd', 2, shuffle, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=['u8', 'u16'])
@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("clevel", (3, 4))
def test_zstd_lazy_levels_match_tensorstore(tmp_path, clevel, shuffle,
                                            dtype):
    check(tmp_path, 'zstd', clevel, shuffle, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=['u8', 'u16'])
@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("clevel", (6, 7, 8))
def test_zstd_512k_levels_match_tensorstore(tmp_path, clevel, shuffle,
                                            dtype):
    """Levels 11, 13 and 15 over 512 KiB blosc blocks (lazy2 and btlazy2)
    and the small array's blocks (btopt, btultra)."""
    check(tmp_path, 'zstd', clevel, shuffle, dtype)
