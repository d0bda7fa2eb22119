"""Port device index build (parallel/devbuild.py) vs the JAX package's
build_device_index (interpret=True: its XLA sketch, no Pallas), tolerance
0: every table (h2r or krows, keys2, sc2, bucket_start, pos2, S, pstrand,
seq_off, seq_len, rtab) and aux int equal, and meta's counts, mid_occ and
offsets; the port's tables, decoded, equal the port's host MiniIndex; the
krows route (MM2TPU_DEVBUILD_H2R=0, or an h2r build that fails) probes as
the JAX package's does; and a PafStep batch through the device-built
index gives the JAX step's records through the JAX device-built index."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minimap2_tpu.parallel.batch as jax_batch
import minimap2_tpu.parallel.devbuild as jax_devbuild
import minimap2_tpu.parallel.engine as jax_engine
from minimap2_tpu.parallel.batch import BatchParams as JaxBatchParams
from minimap2_tpu.parallel.devbuild import build_device_index as jax_build
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.parallel import batch, devbuild, engine
from minimap2_tpu_torch.parallel.batch import BatchParams, DeviceIndex
from minimap2_tpu_torch.parallel.devbuild import build_device_index

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs in several
    worker processes at once, and a thread pool in each, synchronising
    at every elementwise pass, then waits on threads the others hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TABLES = DeviceIndex.LEAVES
AUX = DeviceIndex.AUX


def _genome(seed, lens, n_frac=0.0):
    """tests/test_devbuild.py's genomes: iid bases, iid Ns."""
    rng = np.random.default_rng(seed)
    names, seqs = [], []
    for i, ln in enumerate(lens):
        c = rng.integers(0, 4, ln).astype(np.uint8)
        if n_frac:
            c[rng.random(ln) < n_frac] = 4
        names.append(f"c{i + 1}")
        seqs.append(c)
    return names, seqs


def _clustered_n_genome(seed, lens):
    """Clustered N runs (not iid): the edge rule's reset case, near chunk
    boundaries too."""
    rng = np.random.default_rng(seed)
    names, seqs = _genome(seed, lens)
    for s in seqs:
        for _ in range(max(3, len(s) // 20_000)):
            st = int(rng.integers(0, len(s) - 30))
            s[st:st + int(rng.integers(1, 30))] = 4
    return names, seqs


def _assert_same_build(jdi, jmeta, tdi, tmeta):
    for name in TABLES:
        a, b = getattr(jdi, name), getattr(tdi, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in AUX:
        assert getattr(tdi, name) == getattr(jdi, name), name
    for name in ("n_mini", "n_distinct", "mid_occ"):
        assert getattr(tmeta, name) == getattr(jmeta, name), name
    np.testing.assert_array_equal(tmeta.seq_off, jmeta.seq_off)
    np.testing.assert_array_equal(tmeta.seq_len, jmeta.seq_len)


def _both(names, seqs, w, k, **kw):
    jdi, jmeta = jax_build(names, list(seqs), w, k, interpret=True, **kw)
    tdi, tmeta = build_device_index(names, list(seqs), w, k, device="cpu",
                                    **kw)
    _assert_same_build(jdi, jmeta, tdi, tmeta)
    return tdi, tmeta


@pytest.mark.parametrize("w,k,n_frac", [(10, 15, 0.0), (10, 15, 0.002),
                                        (5, 19, 0.0), (11, 21, 0.001),
                                        (1, 7, 0.0)])
def test_devbuild_matches_jax(w, k, n_frac):
    """Stride-2 (k <= 15) and stride-4 rows, narrow and wide keys; a 9 bp
    contig (< k) and a 20 bp one (the end flush without a window)."""
    rng_seed = hash((w, k)) % 2**32
    names, seqs = _genome(rng_seed, [50_000, 3_000, 120_000, 9, 20], n_frac)
    tdi, meta = _both(names, seqs, w, k)
    assert tdi.h2r.shape[1] == (128 if 2 * k <= 30 else 256)


def test_devbuild_fmt2_matches_jax():
    names, seqs = _genome(11, [70_000, 2_000, 50_000], 0.001)
    tdi, _ = _both(names, seqs, 10, 15, force_pos_fmt=2)
    assert tdi.pos_fmt == 2 and tdi.s_fmt == 1 and tdi.pstrand is not None


def test_devbuild_many_contigs_matches_jax():
    """80 contigs of 3 kb: > 16 contigs, too short for the rid table (the
    binary-search rid route)."""
    names, seqs = _genome(12, [3_000] * 80)
    tdi, _ = _both(names, seqs, 10, 15)
    assert tdi.seq_off.shape[0] == 80 and tdi.rtab is None


def test_devbuild_h2r_chunked_matches_jax(monkeypatch):
    monkeypatch.setenv("MM2TPU_DEVBUILD_H2R", "chunk")
    names, seqs = _genome(41, [150_000, 60_000], 0.001)
    _both(names, seqs, 10, 15)


def test_devbuild_consume_matches_jax():
    """consume=True drops each of the caller's contigs once copied."""
    names, seqs = _genome(7, [90_000, 40_000], 0.001)
    jl, tl = list(seqs), list(seqs)
    jdi, jmeta = jax_build(names, jl, 10, 15, interpret=True, consume=True)
    tdi, tmeta = build_device_index(names, tl, 10, 15, device="cpu",
                                    consume=True)
    assert tl == [None, None] and jl == [None, None]
    _assert_same_build(jdi, jmeta, tdi, tmeta)


def test_devbuild_several_chunks_matches_jax(monkeypatch):
    """~300 kb with clustered N runs in 8-row sketch chunks (chunk_pos
    2^16): five chunks, each owned position sketched once."""
    calls = []
    sk = devbuild.sketch_batch

    def counting(codes, *a, **kw):
        calls.append(tuple(codes.shape))
        return sk(codes, *a, **kw)
    monkeypatch.setattr(devbuild, "sketch_batch", counting)
    names, seqs = _clustered_n_genome(17, [180_000, 90_000, 30_000])
    _both(names, seqs, 10, 15, chunk_pos=1 << 16)
    assert calls == [(8, 8192)] * 5


@pytest.mark.parametrize("case", ["env0", "h2r_fails", "chunk_fails"])
def test_devbuild_krows_route_matches_jax(monkeypatch, case):
    """The krows layout, under MM2TPU_DEVBUILD_H2R=0 and when the h2r
    build fails in both packages (five overflowing tries; the chunked
    build returning None): the tables equal the JAX build's, decode to the
    port's host MiniIndex with every key, and _lookup_anchors on them
    gives the JAX package's anchors (20 contigs: the rid table)."""
    if case == "env0":
        monkeypatch.setenv("MM2TPU_DEVBUILD_H2R", "0")
    elif case == "h2r_fails":
        for mod in (jax_devbuild, devbuild):
            monkeypatch.setattr(mod, "_h2rows_try",
                                lambda *a, **kw: (None, 1 << 40, 0))
    else:
        monkeypatch.setenv("MM2TPU_DEVBUILD_H2R", "chunk")
        for mod in (jax_devbuild, devbuild):
            monkeypatch.setattr(mod, "_build_h2r_chunked",
                                lambda *a, **kw: (None, 0))
    names, seqs = _genome(3, [9_000] * 20)
    tdi, meta = _both(names, seqs, 10, 15)
    assert batch.probe_layout(tdi) == "krows" and tdi.probe_win == 2
    assert tdi.h2r is None and tuple(tdi.keys2.shape) == (1, 2)
    mi = MiniIndex.build_codes(names, seqs, w=10, k=15)
    keys, starts, counts, y = devbuild.host_tables(tdi, meta)
    np.testing.assert_array_equal(keys, mi.keys)
    np.testing.assert_array_equal(starts, mi.starts[:-1])
    np.testing.assert_array_equal(counts, np.diff(mi.starts))
    np.testing.assert_array_equal(y, mi.pos)
    jdi, _ = jax_build(names, list(seqs), 10, 15, interpret=True)
    codes, lens = _reads(seqs, 8, 7)
    p = dict(k=15, L=SHAPE["L"], M=256, A=256, occ_cap=16)
    hhi, hlo, z, is_mini = jax_batch.device_sketch(
        jnp.asarray(codes), jnp.asarray(lens), 15, 10)
    front = jax_batch._compact_minimizers(hhi, hlo, z, is_mini, p["M"])
    want = jax_batch._lookup_anchors(jdi, *front, jnp.asarray(lens),
                                     JaxBatchParams(**p), True)
    got = batch._lookup_anchors(
        tdi, *(torch.from_numpy(np.array(x).view(np.int32)
                                if x.dtype == jnp.uint32 else np.array(x))
               for x in front), torch.from_numpy(lens), BatchParams(**p))
    assert int(np.asarray(want[5]).sum()) > 500
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy().astype(np.int64),
                                      np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("fmt", [1, 2])
def test_devbuild_decodes_to_host_index(fmt):
    """The port's device tables equal the port's own host MiniIndex, and
    mid_occ its cal_max_occ(2e-4), on a genome with a repeat."""
    names, seqs = _clustered_n_genome(4, [60_000, 40_000, 2_000])
    seqs[0][30_000:32_000] = seqs[0][:2_000]
    di, meta = build_device_index(names, list(seqs), 10, 15, device="cpu",
                                  force_pos_fmt=fmt)
    mi = MiniIndex.build_codes(names, seqs, w=10, k=15)
    keys, starts, counts, y = devbuild.host_tables(di, meta)
    assert meta.n_mini == len(mi.pos) and meta.n_distinct == len(mi.keys)
    np.testing.assert_array_equal(keys, mi.keys)
    np.testing.assert_array_equal(starts, mi.starts[:-1])
    np.testing.assert_array_equal(counts, np.diff(mi.starts))
    np.testing.assert_array_equal(y, mi.pos)
    assert meta.mid_occ == mi.cal_max_occ(2e-4)
    assert [s.name for s in meta.seq_table().seq] == names


SHAPE = dict(k=15, w=10, L=1024, M=256, A=256, occ_cap=16, chain_window=64,
             bw=500, bw_long=20000)


def _reads(seqs, n, seed):
    """n 900 bp reads with 3% substitutions, read i from contig i %
    len(seqs), every other one reverse-complemented: (codes, lens) at
    SHAPE's L."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        c = seqs[i % len(seqs)]
        st = int(rng.integers(0, len(c) - 900))
        r = c[st:st + 900].copy()
        m = rng.random(900) < 0.03
        r[m] = rng.integers(0, 4, int(m.sum()))
        reads.append(np.frombuffer(b"ACGT", np.uint8)[
            (3 - r)[::-1] if i % 2 else r].tobytes())
    return engine.encode_batch(reads, SHAPE["L"])


def _batch(seqs, n, seed):
    """_reads, packed for PafStep."""
    codes, lens = _reads(seqs, n, seed)
    return engine.pack_codes(codes) + (lens,)


def _jax_records(jdi, batch):
    jstep = jax_engine.make_paf_step(jdi, JaxBatchParams(**SHAPE), K=5,
                                     min_sc=40, interpret=True)
    return np.asarray(jstep(*(jnp.asarray(x) for x in batch)))


def _port_records(di, batch):
    step = engine.PafStep(di, BatchParams(**SHAPE), K=5, min_sc=40)
    return step(*(torch.from_numpy(x) for x in batch)).numpy()


@pytest.mark.parametrize("fmt", [1, 2])
def test_paf_step_through_devbuild_matches_jax(fmt):
    """8 reads (B % 128 != 0: both sides take the windowed chain scan)
    through PafStep on the port's device-built index give the records of
    the JAX step on the JAX device-built index, on 20 contigs (the rid
    table), with both position formats."""
    names, seqs = _genome(23, [9_000] * 20)
    batch = _batch(seqs, 8, 5)
    jdi, _ = jax_build(names, list(seqs), 10, 15, interpret=True,
                       force_pos_fmt=fmt)
    tdi, _ = build_device_index(names, list(seqs), 10, 15, device="cpu",
                                force_pos_fmt=fmt)
    assert tdi.rtab is not None and tdi.pos_fmt == fmt
    want, got = _jax_records(jdi, batch), _port_records(tdi, batch)
    assert got.shape == want.shape == (10, 5, 8)
    np.testing.assert_array_equal(got, want)
    assert (want[0, 0] > 100).all()         # every read maps


@pytest.mark.parametrize("fmt", [1, 2])
def test_paf_step_few_contigs_host_coordinates(fmt):
    """<= 16 contigs (the unrolled rid compares): records through the
    device-built index equal those through the host-built one.  The JAX
    package starts contig 0 at offset 0 there, not at seq_off[0] = OV, so
    its device-built records on contig 0 sit OV bases to the right (a
    fault of the reference, ROADMAP Queue 3); every other plane agrees."""
    names, seqs = _genome(29, [9_000] * 8)
    batch = _batch(seqs, 8, 6)
    tdi, meta = build_device_index(names, list(seqs), 10, 15, device="cpu",
                                   force_pos_fmt=fmt)
    hdi = DeviceIndex.from_host(MiniIndex.build_codes(names, seqs, 10, 15),
                                "cpu", force_pos_fmt=fmt)
    got = _port_records(tdi, batch)
    np.testing.assert_array_equal(got, _port_records(hdi, batch))
    assert (got[0, 0] > 100).all() and (got[7, 0] == 0).sum() == 1
    jdi, _ = jax_build(names, list(seqs), 10, 15, interpret=True,
                       force_pos_fmt=fmt)
    want = _jax_records(jdi, batch)
    shift = np.where(got[7] == 0, int(meta.seq_off[0]), 0)
    assert shift.max() == 32
    np.testing.assert_array_equal(want[4:6], got[4:6] + shift)
    np.testing.assert_array_equal(np.delete(want, [4, 5], 0),
                                  np.delete(got, [4, 5], 0))
