"""Every index layout of the port's DeviceIndex vs the JAX package's
(tolerance 0; the JAX Pallas kernels in interpret mode, the port's plain
versions on the CPU):

(a) the empty index (a reference without a minimizer) through both
    --batch CLIs: the same PAF, exit 0;
(b) the h2 table (MM2TPU_H2R=0) at k15 (key32 slots) and k19 (wide
    slots): every leaf and aux int equal to JAX from_host's, the anchors
    of _lookup_anchors equal to JAX's and to the port's own h2r probe;
(c) the bucket layouts (MM2TPU_H2R=0 with the host library unavailable in
    both packages): the windowed krows probe, the binary search within a
    bucket (probe_win 0, no krows) and over all keys (no bucket_start);
(d) the legacy h2 mask map (a power-of-two table, mulhi off);
(e) map_batch at (pos_fmt, s_fmt) (1, 0), (2, 1), (0, 0), (0, 1) and under
    MM2TPU_PACK_S=1;
(f) the .npz cache both ways, and a corrupt cache rebuilt;
(g) the compaction and the HPC compaction at 65536 lanes against the JAX
    routes on every valid lane, and the chunked sort1 route against
    sort1_rows_plain at full width;
(h) the --batch CLI (PAF and -a) under MM2TPU_H2R=0.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minimap2_tpu.cli as jax_cli
import minimap2_tpu.native as jax_native
import minimap2_tpu.parallel.engine as jax_engine
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.parallel import batch as jb
from minimap2_tpu.utils.intfloat import SEQ_NT4
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch import native
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.ops import sort
from minimap2_tpu_torch.parallel import batch, engine

jax.config.update("jax_platforms", "cpu")

SHAPE = dict(L=512, M=128, A=256, QP=512, TP=512, W=256, ext_w=200,
             chain_window=32)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _world(seed, glen, k, n=8, L=512):
    """tests/test_batch.py's tiny_world and _sim: a random genome and n
    reads of 300..L-1 bp with 5% substitutions, odd ones
    reverse-complemented; both packages' host indexes."""
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT"), glen))
    codes = np.full((n, L), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        st = int(rng.integers(0, len(ref) - 600))
        ln = int(rng.integers(300, L))
        seq = SEQ_NT4[np.frombuffer(ref[st:st + ln].encode(),
                                    np.uint8)].copy()
        mut = rng.random(ln) < 0.05
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        if i % 2:
            seq = (3 - seq)[::-1].copy()
        codes[i, :ln] = seq
        lens[i] = ln
    return (JaxMiniIndex.build(["chr1"], [ref], w=10, k=k),
            MiniIndex.build(["chr1"], [ref], w=10, k=k), codes, lens)


@pytest.fixture(scope="module")
def world15():
    return _world(3, 20_000, 15)


@pytest.fixture(scope="module")
def world19():
    return _world(11, 30_000, 19)


def _leaves_equal(jdi, tdi):
    """Every leaf (values, u32/i32 dtypes, presence) and aux int equal."""
    assert tdi.aux_dict() == jdi.aux_dict()
    got = tdi.to_numpy()
    for name in batch.DeviceIndex.LEAVES:
        a = getattr(jdi, name)
        assert (a is None) == (name not in got), name
        if a is not None:
            a = np.asarray(a)
            assert got[name].dtype == a.dtype, name
            np.testing.assert_array_equal(got[name], a, err_msg=name)


def _anchors(jdi, tdi, world, k):
    """Both packages' _lookup_anchors on the same compacted minimizers (the
    JAX XLA sketch and rank-scatter compaction); returns (jax, port)
    planes as NumPy int64."""
    _, _, codes, lens = world
    p = jb.BatchParams(k=k, L=512, M=128, A=256, chain_window=32)
    hhi, hlo, z, is_mini = jb.device_sketch(jnp.asarray(codes),
                                            jnp.asarray(lens), k, 10)
    front = jb._compact_minimizers(hhi, hlo, z, is_mini, p.M)
    want = jb._lookup_anchors(jdi, *front, jnp.asarray(lens), p, True)
    tf = [torch.from_numpy(np.array(x).view(np.int32) if
                           np.asarray(x).dtype == np.uint32 else
                           np.array(x)) for x in front]
    got = batch._lookup_anchors(tdi, *tf, torch.from_numpy(lens),
                                batch.BatchParams(k=k, L=512, M=128, A=256,
                                                  chain_window=32))
    conv = [np.asarray(x).astype(np.int64) for x in want]
    out = [x.numpy().astype(np.int64) for x in got]
    assert int(conv[5].sum()) > 100        # anchors found
    return conv, out


def _assert_planes(want, got):
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b, a, err_msg=f"plane {i}")


# ---------------------------------------------------------------------------
# (a) the empty index
# ---------------------------------------------------------------------------


def test_empty_index_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """One contig of 62 N (no minimizer, K = 0) and one 56 bp read: the
    JAX CLI builds the bucket layout with K = 0 and writes the read
    unmapped; the port does the same."""
    ref, qry = tmp_path / "nref.fa", tmp_path / "q.fa"
    ref.write_text(">n\n" + "N" * 62 + "\n")
    qry.write_text(">r\nACGTTGCAACGTAGCTAGCTAGGATCCGATCGATCGGCTAGCTAGCATCGATCGAT"
                   "\n")
    for mod in (jax_engine, engine):
        monkeypatch.setattr(mod, "run_batched_cli", functools.partial(
            mod.run_batched_cli, batch_reads=8, L=512))
    argv = ["--batch", "-x", "map-ont", str(ref), str(qry)]
    outs = []
    for cli, kw in ((jax_cli, {}), (port_cli, {"device": "cpu"})):
        assert cli.main(argv, **kw) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    mi = MiniIndex.build(["n"], ["N" * 62], w=10, k=15)
    di = batch.DeviceIndex.from_host(mi, "cpu")
    assert batch.probe_layout(di) == "bucket"
    assert tuple(di.keys2.shape) == (64, 2) and (di.keys2 == -1).all()
    assert tuple(di.bucket_start.shape) == (17,) and di.n_probe == 1
    assert di.probe_win == 0 and tuple(di.pos2.shape) == (1,)


# ---------------------------------------------------------------------------
# (b) the h2 table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [15, 19])
def test_h2_probe_matches_jax(world15, world19, monkeypatch, k):
    """The counterpart of the JAX package's test_h2r_probe_matches_fallback
    and test_h2r_probe_wide_keys: the h2 table's anchors equal JAX's and
    the port's own h2r probe's."""
    world = world15 if k == 15 else world19
    jmi, tmi = world[:2]
    h2r = batch.DeviceIndex.from_host(tmi, "cpu")
    monkeypatch.setenv("MM2TPU_H2R", "0")
    jdi = jb.DeviceIndex.from_host(jmi, 1)[0]
    tdi = batch.DeviceIndex.from_host(tmi, "cpu")
    assert batch.probe_layout(tdi) == "h2" and tdi.h2_nb > 0
    assert tdi.h2.shape[1] == (12 if k == 15 else 32)
    _leaves_equal(jdi, tdi)
    want, got = _anchors(jdi, tdi, world, k)
    _assert_planes(want, got)
    _assert_planes(want, _anchors(jdi, h2r, world, k)[1])


# ---------------------------------------------------------------------------
# (c) the bucket layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["krows", "bucket", "searchsorted"])
def test_bucket_probes_match_jax(world15, monkeypatch, route):
    jmi, tmi = world15[:2]
    monkeypatch.setenv("MM2TPU_H2R", "0")
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    jdi = jb.DeviceIndex.from_host(jmi, 1)[0]
    tdi = batch.DeviceIndex.from_host(tmi, "cpu")
    assert tdi.probe_win == 2 and tdi.krows is not None
    _leaves_equal(jdi, tdi)
    if route != "krows":
        # the same leaves through both classes' constructors, without
        # krows (and, for searchsorted, without bucket_start)
        leaves = {n: np.asarray(getattr(jdi, n))
                  for n in ("keys2", "sc2", "pos2", "S", "seq_off",
                            "seq_len", "bucket_start")}
        if route == "searchsorted":
            leaves["bucket_start"] = None
        aux = dict(jdi.aux_dict(), probe_win=0)
        jdi = jb.DeviceIndex(
            *(None if v is None else jnp.asarray(v)
              for v in leaves.values()), **aux)
        tdi = batch.DeviceIndex.from_numpy(leaves, aux, "cpu")
        _leaves_equal(jdi, tdi)
    assert batch.probe_layout(tdi) == route
    _assert_planes(*_anchors(jdi, tdi, world15, 15))


# ---------------------------------------------------------------------------
# (d) the legacy h2 mask map
# ---------------------------------------------------------------------------


def test_h2_mask_map_matches_jax(world15, monkeypatch):
    """A power-of-two h2 table with the low-bits bucket map (h2_nb 0,
    h2_bits log2 NB), built by the JAX native builder with mulhi off: the
    port's builder gives the same table, and both probes the same
    anchors."""
    jmi, tmi = world15[:2]
    monkeypatch.setenv("MM2TPU_H2R", "0")
    jdi0 = jb.DeviceIndex.from_host(jmi, 1)[0]
    K = len(jmi.keys)
    bits = (K // 3).bit_length()
    while True:
        table, ov = jax_native.build_hash2_table(jmi.keys, jmi.starts,
                                                 1 << bits, 4, True)
        if ov == 0:
            break
        bits += 1
    mine, ov = native.build_hash2_table(tmi.keys, tmi.starts, 1 << bits, 4,
                                        True)
    assert ov == 0
    np.testing.assert_array_equal(mine, table)
    aux = dict(jdi0.aux_dict(), h2_nb=0, h2_bits=bits)
    leaves = {n: getattr(jdi0, n) for n in batch.DeviceIndex.LEAVES}
    leaves["h2"] = jnp.asarray(table)
    jdi = jb.DeviceIndex(**leaves, **aux)
    tdi = batch.DeviceIndex.from_numpy(
        {n: None if v is None else np.asarray(v) for n, v in leaves.items()},
        aux, "cpu")
    _assert_planes(*_anchors(jdi, tdi, world15, 15))


# ---------------------------------------------------------------------------
# (e) pos_fmt and s_fmt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", [(1, 0), (2, 1), (0, 0), (0, 1), "env"])
def test_pos_s_fmt_map_batch_matches_jax(world15, monkeypatch, fmt):
    """The counterpart of the JAX package's
    test_pos_fmt2_packed_s_matches_fmt1: map_batch's dicts equal JAX's at
    each (pos_fmt, s_fmt); "env" is MM2TPU_PACK_S=1 (s_fmt 1 in both)."""
    jmi, tmi, codes, lens = world15
    if fmt == "env":
        monkeypatch.setenv("MM2TPU_PACK_S", "1")
        kw = {}
    else:
        kw = dict(force_pos_fmt=fmt[0], force_s_fmt=fmt[1])
    jdi = jb.DeviceIndex.from_host(jmi, 1, **kw)[0]
    tdi = batch.DeviceIndex.from_host(tmi, "cpu", **kw)
    _leaves_equal(jdi, tdi)
    assert tdi.s_fmt == (1 if fmt == "env" else fmt[1])
    if tdi.pos_fmt == 0:
        assert tdi.pos2.shape[1] == 2 and tdi.rtab is None
    want = jb.map_batch(jdi, jnp.asarray(codes), jnp.asarray(lens),
                        jb.BatchParams(**SHAPE), interpret=True)
    got = batch.map_batch(tdi, torch.from_numpy(codes),
                          torch.from_numpy(lens), batch.BatchParams(**SHAPE))
    assert set(got) == set(want)
    for key, w_ in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w_),
                                      err_msg=key)
    assert (got["chain_score"] > 50).all() and (got["ext_score"] > 0).all()


# ---------------------------------------------------------------------------
# (f) the .npz cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["jax_to_port", "port_to_jax", "corrupt"])
def test_cache_matches_jax(world15, tmp_path, monkeypatch, case):
    """One .npz serves both packages (s0_<leaf> arrays and meta); a file
    that does not load is rebuilt and rewritten by either."""
    jmi, tmi = world15[:2]
    path = str(tmp_path / "idx.npz")
    monkeypatch.setenv("MM2TPU_H2R", "0")
    fresh_j = jb.DeviceIndex.from_host(jmi, 1)[0]
    if case == "jax_to_port":
        jb.DeviceIndex.from_host(jmi, 1, cache=path)
        # a load only: the port's builder must not run
        monkeypatch.setattr(batch, "host_layout", None)
        _leaves_equal(fresh_j, batch.DeviceIndex.from_host(tmi, "cpu",
                                                           cache=path))
    elif case == "port_to_jax":
        _leaves_equal(fresh_j, batch.DeviceIndex.from_host(tmi, "cpu",
                                                           cache=path))
        _leaves_equal(jb.DeviceIndex._load_cache(path, 1)[0],
                      batch.DeviceIndex.from_host(tmi, "cpu", cache=path))
    else:
        for build in (lambda: jb.DeviceIndex.from_host(jmi, 1,
                                                       cache=path)[0],
                      lambda: batch.DeviceIndex.from_host(tmi, "cpu",
                                                          cache=path)):
            with open(path, "wb") as f:
                f.write(b"not an npz")
            built = build()
            if isinstance(built, batch.DeviceIndex):
                _leaves_equal(fresh_j, built)
            else:
                assert built.aux_dict() == fresh_j.aux_dict()
            # rewritten: it now loads in the other package
            _leaves_equal(jb.DeviceIndex._load_cache(path, 1)[0],
                          batch.DeviceIndex._load_cache(path, "cpu"))


# ---------------------------------------------------------------------------
# (g) the compaction past 32768 lanes
# ---------------------------------------------------------------------------


def _sparse_rows(seed, B, L):
    """Sketch-like planes at minimizer density ~2/(w+1), w 10."""
    rng = np.random.default_rng(seed)
    hhi = rng.integers(0, 1 << 24, (B, L), dtype=np.uint32)
    hlo = rng.integers(0, 1 << 32, (B, L), dtype=np.uint64).astype(np.uint32)
    z = rng.integers(0, 2, (B, L)).astype(np.int32)
    is_mini = rng.random((B, L)) < 2 / 11
    is_mini[1, L // 2:] = False             # one row with a dry half
    return hhi, hlo, z, is_mini


@pytest.mark.parametrize("what", ["minimizers", "hpc"])
def test_compaction_past_32768_matches_jax(what):
    B, L = 2, 65536
    if what == "minimizers":
        hhi, hlo, z, is_mini = _sparse_rows(21, B, L)
        M = 16384
        want = jb._compact_minimizers(*(jnp.asarray(x) for x in
                                        (hhi, hlo, z, is_mini)), M)
        got = batch._compact_minimizers(
            torch.from_numpy(hhi.view(np.int32)),
            torch.from_numpy(hlo.view(np.int32)), torch.from_numpy(z),
            torch.from_numpy(is_mini), M)
        want = [np.asarray(x).astype(np.int64) for x in want]
        got = [x.numpy().astype(np.int64) for x in got]
        ok = want[4].astype(bool)
        np.testing.assert_array_equal(got[4], want[4])
        assert 10_000 < ok.sum() < 2 * M
        for a, b in zip(want[:4], got[:4]):
            np.testing.assert_array_equal((b & 0xFFFFFFFF)[ok],
                                          (a & 0xFFFFFFFF)[ok])
    else:
        rng = np.random.default_rng(22)
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[0, 1000:1200] = 2                 # a long run
        lens = np.array([L, 40_000], np.int32)
        want = [np.asarray(x) for x in jb.hpc_compact(
            jnp.asarray(codes), jnp.asarray(lens))]
        got = [x.numpy() for x in batch.hpc_compact(
            torch.from_numpy(codes), torch.from_numpy(lens))]
        np.testing.assert_array_equal(got[2], want[2])
        for b in range(B):
            n = int(want[2][b])
            for a, g in zip(want[:2], got[:2]):
                np.testing.assert_array_equal(g[b, :n], a[b, :n])


def test_sort1_chunked_matches_plain():
    """sort1_ascending past 32768 lanes (chunks + gather) equals
    sort1_rows_plain at full width, keep included."""
    hhi, hlo, z, is_mini = _sparse_rows(23, 2, 65536)
    pos = np.arange(65536, dtype=np.int32)[None, :]
    key = torch.from_numpy(np.where(is_mini, (pos << 1) | z,
                                    sort.KEY_NONE).astype(np.int32))
    want = sort.sort1_rows_plain(key)
    torch.testing.assert_close(sort.sort1_ascending(key), want, rtol=0,
                               atol=0)
    torch.testing.assert_close(sort.sort1_ascending(key, keep=5000),
                               want[:, :5000], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (h) the CLI on the h2 layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["paf", "sam"])
def test_cli_h2_matches_jax(tmp_path, monkeypatch, mode):
    """--batch -x map-ont (PAF) and --batch -a under MM2TPU_H2R=0 on
    MT-human.fa with 8 reads cut from tests/data/MT-*.fa (2% substitutions,
    odd ones reverse-complemented): byte-identical output."""
    rng = np.random.default_rng(31)
    reads = []
    for i, src in enumerate(["MT-human"] * 6 + ["MT-orang"] * 2):
        seq = "".join(ln.strip() for ln in open(f"tests/data/{src}.fa")
                      if not ln.startswith(">")).upper().encode()
        st = int(rng.integers(0, len(seq) - 500))
        r = np.frombuffer(seq[st:st + int(rng.integers(300, 500))],
                          np.uint8).copy()
        m = rng.random(len(r)) < 0.02
        r[m] = ACGT[rng.integers(0, 4, int(m.sum()))]
        if i % 2:
            r = np.frombuffer(r.tobytes().translate(
                bytes.maketrans(b"ACGT", b"TGCA"))[::-1], np.uint8)
        reads.append(f">r{i}\n{r.tobytes().decode()}\n")
    qry = tmp_path / "q.fa"
    qry.write_text("".join(reads))
    monkeypatch.setenv("MM2TPU_H2R", "0")
    for mod in (jax_engine, engine):
        monkeypatch.setattr(mod, "run_batched_cli", functools.partial(
            mod.run_batched_cli, batch_reads=8, L=512))
        monkeypatch.setattr(mod, "run_batched_align_cli", functools.partial(
            mod.run_batched_align_cli, batch_reads=8, L=512,
            align_kw={"QP": 768, "TP": 1280, "W": 256, "sub": 8}))
    out = tmp_path / "out"
    opts = ["-x", "map-ont"] + (["-a"] if mode == "sam" else [])
    texts = []
    for cli, kw in ((jax_cli, {}), (port_cli, {"device": "cpu"})):
        assert cli.main(["--batch", *opts, "-o", str(out),
                         "tests/data/MT-human.fa", str(qry)], **kw) == 0
        texts.append(out.read_text())
    assert texts[1] == texts[0]
    assert sum(ln.split("\t")[2 if mode == "sam" else 5] != "*"
               for ln in texts[0].splitlines()
               if not ln.startswith("@")) >= 6
