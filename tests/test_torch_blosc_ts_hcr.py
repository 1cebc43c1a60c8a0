"""The port's blosc lz4hc, zlib chunks against tensorstore's: every
clevel of {0, 1, 5, 9}, shuffle of {0, 1, 2, -1} and u8/u16, as
``torch_blosc_matrix.check`` sets out (decoded equal both ways, the
same headers and files, C frames byte-equal to the plain version's)."""

import pytest

from torch_blosc_matrix import CLEVELS, DTYPES, SHUFFLES, check


@pytest.mark.parametrize("dtype", DTYPES, ids=['u8', 'u16'])
@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("clevel", CLEVELS)
@pytest.mark.parametrize("cname", ('lz4hc', 'zlib'))
def test_matches_tensorstore(tmp_path, cname, clevel, shuffle, dtype):
    check(tmp_path, cname, clevel, shuffle, dtype)


@pytest.mark.parametrize("clevel", (2, 3, 7))
def test_lz4hc_levels_match_tensorstore(tmp_path, clevel):
    check(tmp_path, 'lz4hc', clevel, 1, DTYPES[1])
