"""The host index the benchmark hands the program, from a device build on
the CPU, equals the program's host build of the same genome."""
import numpy as np
import pytest

from benchmarks import genome, hostindex


@pytest.mark.parametrize("k,w", [(15, 10), (21, 11)])
def test_host_index_equals_the_host_build(k, w):
    from minimap2_tpu_torch.index.index import MiniIndex
    from minimap2_tpu_torch.parallel import devbuild
    names, parts = genome.make(9, 600_000, 5, "cpu", n_big=3)
    codes = [p.to("cpu", copy=True).numpy() for p in parts]
    di, meta = devbuild.build_device_index(names, parts, w, k,
                                           cap_frac=0.21, device="cpu")
    got, secs = hostindex.host_index(di, meta, codes)
    assert secs > 0
    want = MiniIndex.build_codes(names, codes, w, k)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.starts, want.starts)
    assert np.array_equal(got.pos, want.pos)
    assert np.array_equal(got.S, want.S)
    assert [(s.name, s.offset, s.length) for s in got.seq] == \
        [(s.name, s.offset, s.length) for s in want.seq]
