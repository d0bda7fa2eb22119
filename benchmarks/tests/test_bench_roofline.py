"""Roofline counts on small shapes against counts by hand."""
import pytest

from benchmarks.roofline import bound_ms, extd2


def _cells_by_hand(ql, tl, w):
    n = 0
    for i in range(ql):            # query row i, target column j
        for j in range(tl):
            r = i + j
            if (r - w + 1) >> 1 <= j <= (r + w) >> 1:
                n += 1
    return n


@pytest.mark.parametrize("ql,tl,w", [(5, 5, 100), (7, 4, 100), (10, 10, 2),
                                     (12, 9, 3), (20, 26, 5)])
def test_band_cells_by_hand(ql, tl, w):
    assert extd2.band_cells([(ql, tl)], w) == _cells_by_hand(ql, tl, w)


def test_band_cells_of_an_unbanded_job_is_its_matrix():
    assert extd2.band_cells([(3, 4), (2, 2)], 1000) == 12 + 4


def test_work_and_bound():
    nb, nops = extd2.work([(3, 4)], 1000)
    assert nops == 40 * 12
    assert nb == 12 + 7 + 8 + 64
    assert bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert bound_ms(0, 67e9) == pytest.approx(1.0)
