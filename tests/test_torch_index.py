"""Port index vs the JAX package: the host MiniIndex (keys, starts, pos)
and the DeviceIndex tables (h2r, pos2, pstrand, S, seq_off, seq_len,
rtab, and the keys2 / sc2 / bucket_start placeholders) and aux ints are
byte-equal to DeviceIndex.from_host's, over the layouts the h2r route can
take."""
import numpy as np
import pytest

import jax

from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.parallel.batch import DeviceIndex as JaxDeviceIndex
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.parallel.batch import DeviceIndex

jax.config.update("jax_platforms", "cpu")

LEAVES = DeviceIndex.LEAVES


def _genome(case):
    rng = np.random.default_rng(len(case))
    if case in ("many", "many_short"):
        lens = [4096 + int(rng.integers(0, 3000)) for _ in range(20)]
        if case == "many_short":
            lens[7] = 900
    else:
        lens = [40000]
    seqs = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    seqs[0][100:140] = 4                       # an N run
    names = [f"c{i}" for i in range(len(seqs))]
    return names, seqs


CASES = {            # case -> (k, w, force_pos_fmt, what it exercises)
    "one": (15, 10, None),          # 1 contig, stride-2 rows, pos_fmt 1
    "many": (15, 10, None),         # > 16 contigs >= 4 KiB: rtab
    "many_short": (15, 10, None),   # > 16 contigs, one short: no rtab
    "fmt2": (15, 10, 2),            # pos_fmt 2 + pstrand, packed S
    "k19": (19, 10, None),          # 38-bit keys: stride-4 rows
}


def _build(case):
    k, w, fmt = CASES[case]
    names, seqs = _genome("one" if case in ("fmt2", "k19") else case)
    jmi = JaxMiniIndex.build_codes(names, seqs, w=w, k=k)
    tmi = MiniIndex.build_codes(names, seqs, w=w, k=k)
    jdi = JaxDeviceIndex.from_host(jmi, 1, force_pos_fmt=fmt)[0]
    tdi = DeviceIndex.from_host(tmi, "cpu", force_pos_fmt=fmt)
    return jmi, tmi, jdi, tdi


@pytest.mark.parametrize("case", list(CASES))
def test_device_index_tables_match_jax(case):
    jmi, tmi, jdi, tdi = _build(case)
    for name in ("keys", "starts", "pos"):
        np.testing.assert_array_equal(getattr(tmi, name), getattr(jmi, name))
    assert [vars(s) for s in tmi.seq] == [vars(s) for s in jmi.seq]
    for name in LEAVES:
        j, t = getattr(jdi, name), getattr(tdi, name)
        assert (j is None) == (t is None), name
        if j is not None:
            j = np.asarray(j)
            assert t.shape == j.shape, name
            assert t.numpy().tobytes() == j.tobytes(), name
    assert tdi.aux_dict() == {a: int(v) for a, v in jdi.aux_dict().items()}
    if case == "many":
        assert tdi.rtab is not None
    if case == "many_short":
        assert tdi.rtab is None and tdi.seq_off.shape[0] > 16
    if case == "fmt2":
        assert tdi.pstrand is not None and tdi.s_fmt == 1
    if case == "k19":
        assert tdi.h2r.shape[1] == 256 and tdi.key_bits == 38


def test_from_numpy_round_trip():
    jmi, tmi, jdi, tdi = _build("many")
    leaves = {n: (None if getattr(jdi, n) is None
                  else np.asarray(getattr(jdi, n)))
              for n in JaxDeviceIndex._CACHE_LEAVES}
    di = DeviceIndex.from_numpy(leaves, jdi.aux_dict(), "cpu")
    assert di.aux_dict() == tdi.aux_dict()
    for name in LEAVES:
        a, b = getattr(di, name), getattr(tdi, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and bool((a == b).all()), name


def test_cal_max_occ_matches_jax():
    names, seqs = _genome("one")
    seqs = [np.tile(seqs[0][:3000], 6)]        # repeats: a real threshold
    jmi = JaxMiniIndex.build_codes(names, seqs, w=10, k=15)
    tmi = MiniIndex.build_codes(names, seqs, w=10, k=15)
    for f in (2e-4, 0.01, 0.1):
        assert tmi.cal_max_occ(f) == jmi.cal_max_occ(f)


# -- the host library's index build: batched sketch + stable radix sort --

def _codes_with_ns(rng, n):
    """Random codes with N runs and homopolymer runs (HPC has work)."""
    c = rng.integers(0, 4, n).astype(np.uint8)
    for st in rng.integers(0, n - 50, 6):
        c[st:st + int(rng.integers(1, 30))] = 4
    for st in rng.integers(0, n - 50, 40):
        c[st:st + int(rng.integers(2, 12))] = c[st]
    return c


@pytest.mark.parametrize("k", [15, 21])
@pytest.mark.parametrize("hpc", [False, True])
def test_native_sketch_many_and_radix_sort_match_jax(k, hpc):
    import minimap2_tpu.native as jax_native
    from minimap2_tpu_torch import native
    assert jax_native.available() and native.available()
    rng = np.random.default_rng(100 + k + hpc)
    lens = [30000, 7, 12000, k, 5000]          # two contigs of < k + w
    S = np.concatenate([_codes_with_ns(rng, n) if n > 50
                        else rng.integers(0, 4, n).astype(np.uint8)
                        for n in lens])
    offs = np.cumsum([0] + lens[:-1]).astype(np.int64)
    lens = np.array(lens, np.int64)
    x, y = native.sketch_many(S, offs, lens, 10, k, hpc)
    jx, jy = jax_native.sketch_many(S, offs, lens, 10, k, hpc)
    assert len(x) > 1000
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    # stable: within a key the payloads keep their order, here y order
    # reversed, so a sort by (key, y) would differ
    h = np.ascontiguousarray(x >> np.uint64(8))
    h = np.concatenate([h, h[:500]])
    yr = np.ascontiguousarray(np.concatenate([y, y[:500]])[::-1])
    hr = np.ascontiguousarray(h[::-1])
    jh, jyr = hr.copy(), yr.copy()
    native.radix_sort_pair(hr, yr, 2 * k)
    jax_native.radix_sort_pair(jh, jyr, 2 * k)
    np.testing.assert_array_equal(hr, jh)
    np.testing.assert_array_equal(yr, jyr)
    order = np.argsort(h[::-1], kind="stable")
    np.testing.assert_array_equal(yr, np.concatenate([y, y[:500]])[::-1]
                                  [order])


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_build_codes_routes_match_jax(route, monkeypatch):
    """MiniIndex.build_codes through the host library and through NumPy
    (native.available monkeypatched false) give the JAX build's keys,
    starts and positions, on contigs with Ns and repeats, HPC off and
    on."""
    from minimap2_tpu_torch import native
    calls = []
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        for fn in ("sketch_many", "radix_sort_pair"):
            orig = getattr(native, fn)
            monkeypatch.setattr(native, fn, lambda *a, _f=orig, _n=fn:
                                calls.append(_n) or _f(*a))
    rng = np.random.default_rng(77)
    rep = _codes_with_ns(rng, 3000)
    seqs = [np.concatenate([rep, _codes_with_ns(rng, 20000), rep]),
            rng.integers(0, 4, 9).astype(np.uint8),
            np.concatenate([rep[::-1], rep])]
    names = ["a", "b", "c"]
    for k, flag in ((15, 0), (19, 1)):
        jmi = JaxMiniIndex.build_codes(names, seqs, w=10, k=k, flag=flag)
        tmi = MiniIndex.build_codes(names, seqs, w=10, k=k, flag=flag)
        assert len(tmi.keys) > 1000
        for name in ("keys", "starts", "pos", "S"):
            a, b = getattr(tmi, name), getattr(jmi, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert calls == (["sketch_many", "radix_sort_pair"] * 2
                     if route == "native" else [])
