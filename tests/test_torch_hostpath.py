"""The port's host mapping path vs the JAX package (tolerance 0):

(a) each C++ routine of native/host_map.cpp (sketch, collect_anchors,
    lchain_dp, lchain_rmq, extd2, extz2, exts2, ll) equals the port's
    NumPy version and the JAX package's function (its C++ route, and its
    NumPy route with MM2TPU_NO_NATIVE set) on seeded random inputs;
(b) map_frag_core of both packages gives equal Reg lists and rep_len on
    map-ont (PAF, and -a with the long-join rescue and an inversion),
    map-pb and splice -a reads against one index;
(c) without g++ the host routines raise: there is no other route.
"""
import dataclasses

import numpy as np
import pytest

import minimap2_tpu.config as jax_config
import minimap2_tpu.native as jax_native
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.map import chain as jax_chain
from minimap2_tpu.map import seed as jax_seed
from minimap2_tpu.map.pipeline import map_frag_core as jax_map_frag_core
from minimap2_tpu.ops import ksw2_exts as jax_exts
from minimap2_tpu.ops import ksw2_np as jax_ksw
import minimap2_tpu_torch.config as port_config
from minimap2_tpu_torch import native
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.index.sketch import sketch as sketch_np
from minimap2_tpu_torch.map import chain, pipeline, seed
from minimap2_tpu_torch.map.align_engine import gen_simple_mat
from minimap2_tpu_torch.ops import ksw2_exts, ksw2_np
from minimap2_tpu_torch.utils.intfloat import SEQ_NT4

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
EZ_FIELDS = ("max", "zdropped", "max_q", "max_t", "mqe", "mqe_t", "mte",
             "mte_q", "score", "reach_end", "cigar")


def _ez(ez):
    return tuple(list(v) if f == "cigar" else v
                 for f, v in ((f, getattr(ez, f)) for f in EZ_FIELDS))


def _four_ways(monkeypatch, port_cpp, port_np, jax_fn, *args):
    """The port's C++ and NumPy routes and the JAX function's C++ and NumPy
    routes on the same arguments -> the four results."""
    out = [port_cpp(*args), port_np(*args), jax_fn(*args)]
    with monkeypatch.context() as m:
        m.setenv("MM2TPU_NO_NATIVE", "1")
        out.append(jax_fn(*args))
    return out


def _related(rng, ql, tl, rate):
    """A query and a target of lengths ql, tl sharing a prefix, with
    substitutions at ``rate`` and some N codes."""
    qs = rng.integers(0, 5, ql).astype(np.uint8)
    ts = np.concatenate([qs[:min(ql, tl)],
                         rng.integers(0, 4, max(0, tl - ql)).astype(np.uint8)])
    mut = rng.random(tl) < rate
    ts[mut] = rng.integers(0, 5, int(mut.sum())).astype(np.uint8)
    return qs, ts


@pytest.mark.parametrize("seed_", range(3))
def test_sketch_matches(seed_):
    rng = np.random.default_rng(seed_)
    for _ in range(6):
        n = int(rng.integers(40, 3000))
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n,
                         p=[0.24, 0.24, 0.24, 0.24, 0.04]).tobytes()
        codes = SEQ_NT4[np.frombuffer(seq, np.uint8)]
        for w, k, hpc in ((10, 15, False), (5, 19, True), (19, 19, False),
                          (1, 14, False), (25, 28, True)):
            got = native.sketch(codes, w, k, 3, hpc)
            for want in (sketch_np(codes, w, k, 3, hpc),
                         jax_native.sketch(codes, w, k, 3, hpc)):
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def anchor_world():
    """A 60 kb genome with a tandem repeat family (high-occurrence seeds)
    indexed by both packages."""
    rng = np.random.default_rng(1)
    unit = rng.choice(ACGT, 400).tobytes()
    ref = unit * 25 + rng.choice(ACGT, 50_000).tobytes()
    pmi = MiniIndex.build(["c"], [ref], w=10, k=15)
    jmi = JaxMiniIndex.build(["c"], [ref], w=10, k=15)
    pmo, jmo = port_config.MapOptions(), jax_config.MapOptions()
    port_config.mapopt_update(pmo, pmi)
    jax_config.mapopt_update(jmo, jmi)
    return ref, pmi, jmi, pmo, jmo


@pytest.mark.parametrize("mid_occ", [None, 3])
def test_collect_anchors_matches(anchor_world, monkeypatch, mid_occ):
    ref, pmi, jmi, pmo, jmo = anchor_world
    if mid_occ is not None:      # seed_select's high-occurrence streaks
        pmo.mid_occ = jmo.mid_occ = mid_occ
    rng = np.random.default_rng(2)
    n_anchors = 0
    for _ in range(6):
        ln = int(rng.integers(200, 2500))
        st = int(rng.integers(0, len(ref) - ln))
        q = ref[st:st + ln]
        codes = SEQ_NT4[np.frombuffer(q, np.uint8)]
        mx, my = native.sketch(codes, 10, 15, 0, False)
        got = seed.collect_seed_hits(pmi, pmo, pmo.mid_occ, mx, my, ln, "q")
        want = [seed.collect_seed_hits_np(pmi, pmo, pmo.mid_occ, mx, my, ln,
                                          "q"),
                jax_seed.collect_seed_hits(jmi, jmo, jmo.mid_occ, mx, my, ln,
                                           "q")]
        with monkeypatch.context() as m:
            m.setattr(jax_native, "available", lambda: False)
            want.append(jax_seed.collect_seed_hits(jmi, jmo, jmo.mid_occ, mx,
                                                   my, ln, "q"))
        for w in want:
            np.testing.assert_array_equal(got[0], w[0])
            np.testing.assert_array_equal(got[1], w[1])
            assert got[2] == w[2]
            np.testing.assert_array_equal(got[3], w[3])
        n_anchors += len(got[0])
    assert n_anchors > 100


def _anchors(rng, n, span, jitter):
    rpos = np.sort(rng.integers(0, span, n)).astype(np.uint64)
    qpos = (rpos - rpos[0] + rng.integers(0, jitter, n).astype(np.uint64)) \
        & np.uint64(0xFFFFFFFF)
    rev = (rng.random(n) < 0.3).astype(np.uint64)
    ax = (rev << np.uint64(63)) | rpos
    ay = (np.uint64(15) << np.uint64(32)) | qpos
    order = np.argsort(ax, kind="stable")
    return ax[order], ay[order]


def _same_chains(results):
    """Assert four (u, ax, ay) results equal; return the chain count."""
    for r in results[1:]:
        for a, b in zip(results[0], r):
            np.testing.assert_array_equal(a, b)
    return len(results[0][0])


@pytest.mark.parametrize("seed_", range(3))
def test_lchain_dp_matches(monkeypatch, seed_):
    rng = np.random.default_rng(10 + seed_)
    n_chains = 0
    for t in range(4):
        ax, ay = _anchors(rng, int(rng.integers(50, 800)), 100_000, 60)
        args = (5000, 5000, 500, 25, 5000, 3, 40, np.float32(0.12),
                np.float32(0.0), bool(t % 2), 1, ax, ay)
        n_chains += _same_chains(_four_ways(
            monkeypatch, chain.chain_dp, chain.chain_dp_np,
            jax_chain.chain_dp, *args))
    assert n_chains > 0


@pytest.mark.parametrize("seed_", range(3))
def test_lchain_rmq_matches(monkeypatch, seed_):
    rng = np.random.default_rng(20 + seed_)
    n_chains = 0
    for jitter in (60, 1500, 60, 1500):
        ax, ay = _anchors(rng, int(rng.integers(50, 1200)), 300_000, jitter)
        args = (int(rng.choice([5000, 20000])), int(rng.choice([0, 1000])),
                int(rng.choice([500, 2000])), 25,
                int(rng.choice([1 << 29, 100])), 3, 40, np.float32(0.12),
                np.float32(0.0), ax, ay)
        n_chains += _same_chains(_four_ways(
            monkeypatch, chain.chain_rmq, chain.chain_rmq_np,
            jax_chain.chain_rmq, *args))
    assert n_chains > 0


@pytest.mark.parametrize("seed_", range(3))
def test_extd2_matches(monkeypatch, seed_):
    rng = np.random.default_rng(30 + seed_)
    mat = gen_simple_mat(5, 2, -4, 1)
    for _ in range(8):
        ql, tl = (int(x) for x in rng.integers(1, 300, 2))
        qs, ts = _related(rng, ql, tl, rng.choice([0.05, 0.3]))
        args = (ql, qs, tl, ts, 5, mat, 4, 2, 24, 1,
                int(rng.choice([-1, 50, 300])), int(rng.choice([-1, 400])),
                17, int(rng.choice([0, 0x01, 0x02, 0x08, 0x40, 0x42, 0xC0])))
        res = [_ez(e) for e in _four_ways(
            monkeypatch, native.ksw_extd2, ksw2_np.ksw_extd2,
            jax_ksw.ksw_extd2, *args)]
        assert res[1:] == res[:1] * 3


@pytest.mark.parametrize("seed_", range(2))
def test_extz2_matches(monkeypatch, seed_):
    rng = np.random.default_rng(40 + seed_)
    mat = gen_simple_mat(5, 2, -4, 1)
    for _ in range(8):
        ql, tl = (int(x) for x in rng.integers(1, 250, 2))
        qs, ts = _related(rng, ql, tl, rng.choice([0.05, 0.3]))
        args = (ql, qs, tl, ts, 5, mat, 4, 2, int(rng.choice([-1, 60, 200])),
                int(rng.choice([-1, 400])), 17,
                int(rng.choice([0, 0x01, 0x02, 0x40, 0x42, 0xC0])))
        res = [_ez(e) for e in _four_ways(
            monkeypatch, native.ksw_extz2, ksw2_np.ksw_extz2,
            jax_ksw.ksw_extz2, *args)]
        assert res[1:] == res[:1] * 3


@pytest.mark.parametrize("seed_", range(2))
def test_exts2_matches(monkeypatch, seed_):
    """Spliced targets (GT..AG introns), with and without junction
    arrays, on both splice strands and the complex-splice flag."""
    rng = np.random.default_rng(50 + seed_)
    mat = gen_simple_mat(5, 1, -2, 1)
    for t in range(8):
        ql = int(rng.integers(20, 180))
        e1 = int(rng.integers(5, ql))
        intron = int(rng.integers(40, 200))
        qs = rng.integers(0, 4, ql).astype(np.uint8)
        ts = np.concatenate([qs[:e1], np.array([2, 3], np.uint8),
                             rng.integers(0, 4, intron - 4).astype(np.uint8),
                             np.array([0, 2], np.uint8), qs[e1:]])
        tl = len(ts)
        junc = rng.choice(np.array([0, 1, 2, 4, 8], np.uint8), tl) \
            if t % 2 else None
        args = (ql, qs, tl, ts, 5, mat, 4, 2, 24, 9, 200, 17, 9, 12,
                int(rng.choice([0x100, 0x200, 0x900, 0x108, 0x540])), junc)
        res = [_ez(e) for e in _four_ways(
            monkeypatch, native.ksw_exts2, ksw2_exts.ksw_exts2,
            jax_exts.ksw_exts2, *args)]
        assert res[1:] == res[:1] * 3
        assert any(c & 0xF == 3 for c in res[0][-1]) or t % 2


@pytest.mark.parametrize("seed_", range(2))
def test_ll_matches(monkeypatch, seed_):
    rng = np.random.default_rng(60 + seed_)
    mat = gen_simple_mat(5, 2, -4, 1)
    for _ in range(10):
        ql, tl = (int(x) for x in rng.integers(1, 400, 2))
        qs, ts = _related(rng, ql, tl, rng.choice([0.05, 0.3]))
        args = (ql, qs, tl, ts, 5, mat, 4, 2)
        res = _four_ways(monkeypatch, native.ksw_ll, ksw2_np.ksw_ll,
                         jax_ksw.ksw_ll, *args)
        assert res[1:] == res[:1] * 3


def _mutate(rng, s: bytes, rate: float) -> bytes:
    a = np.frombuffer(s, np.uint8).copy()
    m = rng.random(len(a)) < rate
    a[m] = rng.choice(ACGT, int(m.sum()))
    return a.tobytes()


@pytest.fixture(scope="module")
def genome():
    """A 200 kb genome with a duplicated 3 kb segment (secondaries) and
    three planted genes of 3-4 exons with GT..AG introns, and the spliced
    transcripts of the genes."""
    rng = np.random.default_rng(7)
    g = bytearray(rng.choice(ACGT, 200_000).tobytes())
    g[150_000:153_000] = g[20_000:23_000]
    tx = []
    for gst in (60_000, 90_000, 120_000):
        pos, exons = gst, []
        for _ in range(int(rng.integers(3, 5))):
            ln = int(rng.integers(150, 400))
            exons.append(bytes(g[pos:pos + ln]))
            intron = int(rng.integers(300, 2000))
            g[pos + ln:pos + ln + 2] = b"GT"
            g[pos + ln + intron - 2:pos + ln + intron] = b"AG"
            pos += ln + intron
        tx.append(b"".join(exons))
    return bytes(g), tx


def _reads(rng, g):
    """Genomic test reads of at most 3 kb."""
    junk = rng.choice(ACGT, 1500).tobytes()
    return [_mutate(rng, g[1000:3500], 0.05),
            _mutate(rng, g[40_000:42_000], 0.08).translate(COMP)[::-1],
            # a 2 kb deletion: two chains, the long-join rescue
            _mutate(rng, g[10_000:11_200] + g[13_200:14_600], 0.04),
            # an inverted middle (z-drop, inversion rescue)
            g[30_000:31_000] + g[31_000:31_600].translate(COMP)[::-1]
            + g[31_600:32_600],
            _mutate(rng, g[20_500:22_500], 0.03),        # duplicated
            g[5000:5800] + b"N" * 50 + g[5850:6600],
            junk]


def _map_both(preset, flag, g, reads):
    out = []
    for cfg, MI, fn in ((port_config, MiniIndex, pipeline.map_frag_core),
                        (jax_config, JaxMiniIndex, jax_map_frag_core)):
        io_, mo = cfg.IndexOptions(), cfg.MapOptions()
        cfg.set_opt(preset, io_, mo)
        mo.flag |= flag
        mi = MI.build(["g"], [g], w=io_.w, k=io_.k, flag=io_.flag)
        cfg.mapopt_update(mo, mi)
        res = [fn(mi, [r], mo, f"r{i}")[0] for i, r in enumerate(reads)]
        out.append([([dataclasses.asdict(x) for x in r.regs], r.rep_len)
                    for r in res])
    return out


@pytest.mark.parametrize("preset,flag", [
    ("map-ont", 0), ("map-ont", jax_config.MM_F_CIGAR),
    ("map-pb", jax_config.MM_F_CIGAR), ("splice", jax_config.MM_F_CIGAR)],
    ids=["map-ont-paf", "map-ont-a", "map-pb-a", "splice-a"])
def test_map_frag_core_matches_jax(monkeypatch, genome, preset, flag):
    g, tx = genome
    rng = np.random.default_rng(8)
    reads = _reads(rng, g)
    if preset == "splice":
        reads = [_mutate(rng, t, 0.02) for t in tx] + \
            [tx[1].translate(COMP)[::-1]] + reads[:2]
    calls = []
    rmq = pipeline.chain_rmq
    monkeypatch.setattr(pipeline, "chain_rmq",
                        lambda *a: calls.append(1) or rmq(*a))
    got, want = _map_both(preset, flag, g, reads)
    assert got == want
    n_mapped = sum(bool(regs) for regs, _ in got)
    assert n_mapped >= len(reads) - 1
    if preset.startswith("map-"):
        assert calls                         # the long-join rescue ran
    if flag:
        assert all(r["p"] is not None and r["p"]["cigar"]
                   for regs, _ in got for r in regs)
    if preset == "splice":
        assert any(c & 0xF == 3 for regs, _ in got for r in regs
                   for c in r["p"]["cigar"])
        assert {r["p"]["trans_strand"] for regs, _ in got for r in regs} \
            >= {1, 2}


def test_host_routines_raise_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.ksw_ll(3, np.zeros(3, np.uint8), 3, np.zeros(3, np.uint8), 5,
                      gen_simple_mat(5, 2, -4, 1), 4, 2)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.zdrop_scan(np.zeros(3, np.uint8), np.zeros(3, np.uint8),
                          [3 << 4], gen_simple_mat(5, 2, -4, 1), 5, 4, 2)
