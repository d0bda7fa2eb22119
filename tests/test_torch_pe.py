"""The port's short-read paths vs the JAX package (tolerance 0):

(a) the pairing helpers: qname_same, revcomp_record, iter_fragments;
(b) seg_gen and select_sub_multi on the joint chains of seeded simulated
    pairs (the JAX package's own seeding and chaining of them), and pair
    (mm_pair) on seeded per-segment regions;
(c) the host path: map_fragment + write_fragment on tests/data/sr-r{1,2}.fq
    against MT-human.fa (SAM, PAF, --no-pairing);
(d) run_batched_pe_cli end to end at test_align_batch.py's widths
    (batch_frags 8, L 256, QP 256, TP 768, W 256): byte-identical SAM and
    PAF, and on simulated pairs with ends the device path hands off
    (oversize, junk, unmapped) the same whole fragments on the host path;
(e) cli.main -x sr / -ax sr with one query file and with two.
The JAX Pallas kernels run in interpret mode (the JAX drivers pick it off
the TPU); the port runs its plain versions on the CPU.
"""
import dataclasses
import functools
import io

import numpy as np
import pytest

import jax

import minimap2_tpu.cli as jax_cli
import minimap2_tpu.map.driver as jax_driver
import minimap2_tpu.parallel.engine as jax_engine
from minimap2_tpu import config as jax_config
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.io import fastx as jax_fastx
from minimap2_tpu.map import hit as jax_hit
from minimap2_tpu.map import pe as jax_pe
from minimap2_tpu.map import pipeline as jax_pipeline
from minimap2_tpu.map.chain import chain_dp as jax_chain_dp
from minimap2_tpu.map.seed import collect_seed_hits_heap as jax_seed_hits
from minimap2_tpu.utils.intfloat import qname_hash as jax_qname_hash
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch import config as port_config
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.io import fastx
from minimap2_tpu_torch.map import driver, hit, pe
from minimap2_tpu_torch.parallel import engine

jax.config.update("jax_platforms", "cpu")

MT = "tests/data/MT-human.fa"
SR = ["tests/data/sr-r1.fq", "tests/data/sr-r2.fq"]
KW = {"QP": 256, "TP": 768, "W": 256, "sub": 8}     # test_align_batch.py
COMP = bytes.maketrans(b"ACGT", b"TGCA")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _asdicts(regs):
    return [dataclasses.asdict(r) for r in regs]


@functools.lru_cache(maxsize=None)
def _mt():
    return jax_fastx.read_fasta(MT)


@functools.lru_cache(maxsize=None)
def _mt_dup():
    """MT-human and a diverged copy (1% substitutions) of its bases
    2000-6000: pairs from there have a secondary locus."""
    names, seqs = _mt()
    rng = np.random.default_rng(17)
    dup = bytearray(seqs[0][2000:6000])
    for j in np.flatnonzero(rng.random(len(dup)) < 0.01):
        dup[j] = b"ACGT"[(b"ACGT".index(dup[j]) + 2) % 4]
    return list(names) + ["dup"], list(seqs) + [bytes(dup)]


def _indexes(flag=0, preset="sr", world=_mt):
    """The index of world() and sr options in both packages."""
    names, seqs = world()
    out = []
    for cfg, MI in ((jax_config, JaxMiniIndex), (port_config, MiniIndex)):
        io_opt, mo = cfg.IndexOptions(), cfg.MapOptions()
        cfg.set_opt(preset, io_opt, mo)
        mo.flag |= flag
        mi = MI.build(names, seqs, w=io_opt.w, k=io_opt.k)
        cfg.mapopt_update(mo, mi)
        out += [mi, mo]
    return out          # jmi, jmo, pmi, pmo


def _sim_pairs(n, seed, special=None, lo=0, hi=None):
    """n FR pairs from MT-human: fragment ~N(350, 50) clipped to
    [200, 600], 150 bp ends (r2 the reverse complement of the fragment's
    end), 0.5% substitutions; the fragment from the minus strand for odd
    i; fragments start in [lo, hi).  special maps a pair index to
    "oversize" (a 300 bp r1: past QP), "junk" (r2's middle 50 bases
    random), "zdrop" (r2's middle 32 bases
    random: aligned as a 32-base deletion and insertion, a drop of 112 >
    sr's z-drop 100 that the Kadane trim keeps) or "unmapped" (r2 random).
    Returns (r1 records, r2 records) as (name, seq) lists."""
    ref = _mt()[1][0]
    rng = np.random.default_rng(seed)
    r1s, r2s = [], []
    for i in range(n):
        flen = int(np.clip(rng.normal(350, 50), 200, 600))
        st = int(rng.integers(lo, (hi or len(ref)) - flen))
        frag = bytearray(ref[st:st + flen])
        m = np.flatnonzero(rng.random(flen) < 0.005)
        for j in m:
            frag[j] = b"ACGT"[(b"ACGT".index(frag[j]) + 1) % 4]
        frag = bytes(frag)
        if i % 2:
            frag = frag.translate(COMP)[::-1]
        kind = (special or {}).get(i)
        r1 = frag[:300 if kind == "oversize" else 150]
        r2 = frag[-150:].translate(COMP)[::-1]
        if kind == "junk":
            r2 = r2[:50] + rng.choice(ACGT, 50).tobytes() + r2[100:]
        elif kind == "zdrop":
            r2 = r2[:59] + rng.choice(ACGT, 32).tobytes() + r2[91:]
        elif kind == "unmapped":
            r2 = rng.choice(ACGT, 150).tobytes()
        r1s.append((f"p{i}_{st}/1", r1))
        r2s.append((f"p{i}_{st}/2", r2))
    return r1s, r2s


def _write_fq(path, recs):
    with open(path, "w") as f:
        for nm, s in recs:
            f.write(f"@{nm}\n{s.decode()}\n+\n{'I' * len(s)}\n")
    return str(path)


@pytest.mark.parametrize("a,b", [("r/1", "r/2"), ("r/1", "r"),
                                 ("ab/1", "ac/1"), ("r", "r"), ("r/x", "r/1"),
                                 ("/1", "/2")])
def test_qname_same_matches_jax(a, b):
    assert fastx.qname_same(a, b) == jax_fastx.qname_same(a, b)


def test_revcomp_record_matches_jax():
    rng = np.random.default_rng(2)
    seq = rng.choice(np.frombuffer(b"ACGTNacgtnRYKM", np.uint8), 97).tobytes()
    qual = bytes(rng.integers(33, 74, 97).astype(np.uint8))
    for q in (qual, None):
        got = fastx.revcomp_record(fastx.SeqRecord("x/1", seq, q, "c"))
        want = jax_fastx.revcomp_record(
            jax_fastx.SeqRecord("x/1", seq, q, "c"))
        assert (got.name, got.seq, got.qual, got.comment) == \
            (want.name, want.seq, want.qual, want.comment)
    assert fastx.revcomp_record(fastx.SeqRecord("x", seq, qual)).qual == \
        qual[::-1]


def test_iter_fragments_matches_jax(tmp_path, capsys):
    r1, r2 = _sim_pairs(6, 1)
    inter = _write_fq(tmp_path / "inter.fq",
                      [x for p in zip(r1, r2) for x in p])
    short = _write_fq(tmp_path / "short.fq", r2[:4])
    cases = [(SR, True), ([inter], True), ([inter], False),
             ([_write_fq(tmp_path / "r1.fq", r1), short], True)]
    for queries, frag_mode in cases:
        got = [[(r.name, r.seq, r.qual) for r in f]
               for f in driver.iter_fragments(queries, frag_mode)]
        want = [[(r.name, r.seq, r.qual) for r in f]
                for f in jax_driver.iter_fragments(queries, frag_mode)]
        assert got == want and got
    assert len(got) == 4 and all(len(f) == 2 for f in got)
    assert "different number of records" in capsys.readouterr().err


def _joint_chains(seed, n=12):
    """The JAX package's seeding and joint chaining (map_frag_core up to
    gen_regs) of n simulated pairs from the duplicated region, r2
    reverse-complemented as sr's pe_ori says: [(hash, qlens, u, ax,
    ay)]."""
    jmi, jmo, _, _ = _indexes(jax_config.MM_F_CIGAR, world=_mt_dup)
    r1, r2 = _sim_pairs(n, seed, lo=1800, hi=6200)
    out = []
    for (nm, s1), (_, s2) in zip(r1, r2):
        seqs = [s1, s2.translate(COMP)[::-1]]
        qlens = [len(s) for s in seqs]
        mx, my = jax_pipeline.collect_minimizers(jmi, jmo, seqs)
        ax, ay, _, _ = jax_seed_hits(jmi, jmo, jmo.mid_occ, mx, my,
                                     sum(qlens), nm)
        gap_ref = max(jmo.max_frag_len - sum(qlens), jmo.max_gap)
        u, ax, ay = jax_chain_dp(
            gap_ref, max(sum(qlens), jmo.max_gap), jmo.bw,
            jmo.max_chain_skip, jmo.max_chain_iter, jmo.min_cnt,
            jmo.min_chain_score,
            np.float32(jmo.chain_gap_scale * 0.01 * jmi.k),
            np.float32(jmo.chain_skip_scale * 0.01 * jmi.k), False, 2, ax, ay)
        out.append((jax_qname_hash(nm, sum(qlens), jmo.seed, False), qlens,
                    u, ax, ay))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_seg_gen_and_select_sub_multi_match_jax(seed):
    n_split = n_drop = 0
    for hash_, qlens, u, ax, ay in _joint_chains(seed):
        regs = {}
        for tag, h in (("jax", jax_hit), ("port", hit)):
            regs[tag] = h.gen_regs(hash_, sum(qlens), u, ax, ay, False)
            h.set_parent(regs[tag], 0.5, 0, 12, False, 0.15)
        assert _asdicts(regs["port"]) == _asdicts(regs["jax"])
        for pri_ratio, best_n in ((0.5, 20), (0.99, 1), (0.5, 0), (0.0, 5)):
            args = (pri_ratio, 0.2, 0.7, 598, 42, best_n, 2, qlens)
            got = pe.select_sub_multi(list(regs["port"]), *args)
            want = jax_pe.select_sub_multi(list(regs["jax"]), *args)
            assert _asdicts(got) == _asdicts(want)
            n_drop += len(got) < len(regs["port"])
        got = pe.seg_gen(hash_, qlens, regs["port"], ax, ay)
        want = jax_pe.seg_gen(hash_, qlens, regs["jax"], ax, ay)
        assert len(got) == len(want) == 2
        for (g, gx, gy), (w, wx, wy) in zip(got, want):
            assert _asdicts(g) == _asdicts(w)
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
            n_split += bool(g)
    assert n_split > 12 and n_drop > 0


def _random_regs(h, rng, qlens):
    """Two segments' regions around a few loci (the second end 150-450
    bases past the first, mostly on one strand and contig): primaries and
    secondaries with random DP scores, hashes and mapqs, built from the
    package's Reg."""
    regss = []
    loci = rng.integers(0, 3000, 3)
    for s in range(2):
        regs = []
        for i in range(int(rng.integers(0, 5))):
            rs = int(loci[rng.integers(0, 3)]
                     + (rng.integers(150, 450) if s
                        else rng.integers(0, 100)))
            r = h.Reg(id=i, parent=0 if i and rng.random() < 0.6 else i,
                      rid=int(rng.random() < 0.2), rs=rs, re=rs + 140,
                      qs=int(rng.integers(0, 5)), qe=qlens[s],
                      rev=bool(rng.random() < 0.2),
                      hash=int(rng.integers(0, 1 << 32)),
                      mapq=int(rng.integers(0, 61)),
                      sam_pri=i == 0, cnt=int(rng.integers(2, 20)))
            r.p = h.Extra(dp_max=int(rng.integers(150, 300)))
            regs.append(r)
        regss.append(regs)
    return regss


@pytest.mark.parametrize("seed", range(3))
def test_pair_matches_jax(seed):
    rng_seed = 1000 * seed
    n_proper = n_lift = 0
    for t in range(300):
        qlens = [150, 150]
        got = _random_regs(hit, np.random.default_rng(rng_seed + t), qlens)
        want = _random_regs(jax_hit, np.random.default_rng(rng_seed + t),
                            qlens)
        before = [[r.sam_pri for r in regs] for regs in got]
        pe.pair(598, 33, 12, 2, qlens, got)
        jax_pe.pair(598, 33, 12, 2, qlens, want)
        for g, w in zip(got, want):
            assert _asdicts(g) == _asdicts(w)
        n_proper += any(r.proper_frag for regs in got for r in regs)
        n_lift += [[r.sam_pri for r in regs] for regs in got] != before
    assert n_proper > 50 and n_lift > 0
    # a read-through pair: one primary each, same locus and strand
    for h, mod in ((hit, pe), (jax_hit, jax_pe)):
        a = h.Reg(id=0, parent=0, rs=100, re=250, qs=0, qe=150)
        b = h.Reg(id=0, parent=0, rs=101, re=251, qs=0, qe=150)
        mod.set_pe_thru([150, 150], [[a], [b]])
        assert a.pe_thru and b.pe_thru


def _host_text(drv, mi, mo, queries):
    buf = io.StringIO()
    for frag in drv.iter_fragments(queries, True):
        res = drv.map_fragment(mi, mo, frag)
        drv.write_fragment(buf, mi, mo, frag, [r.regs for r in res],
                           [r.rep_len for r in res])
    return buf.getvalue()


@pytest.mark.parametrize("flag", [
    jax_config.MM_F_CIGAR | jax_config.MM_F_OUT_SAM,
    jax_config.MM_F_CIGAR | jax_config.MM_F_OUT_CG,
    jax_config.MM_F_CIGAR | jax_config.MM_F_OUT_SAM
    | jax_config.MM_F_INDEPEND_SEG], ids=["sam", "paf", "no-pairing"])
def test_map_fragment_matches_jax(flag):
    jmi, jmo, pmi, pmo = _indexes(flag)
    want = _host_text(jax_driver, jmi, jmo, SR)
    got = _host_text(driver, pmi, pmo, SR)
    assert got == want
    lines = got.splitlines()
    assert len(lines) >= 80
    if (flag & jax_config.MM_F_OUT_SAM
            and not flag & jax_config.MM_F_INDEPEND_SEG):
        assert sum(int(t.split("\t")[1]) & 2 != 0 for t in lines) >= 70


def _run_pe(monkeypatch, queries, flag, batch_frags=8):
    """run_batched_pe_cli of both packages; the JAX package's host path
    records the first name of each fragment it maps and calls through.
    Returns (jax text, jax host fragments, port text, port result)."""
    jmi, jmo, pmi, pmo = _indexes(flag)
    host = []
    map_fragment = jax_driver.map_fragment
    monkeypatch.setattr(jax_driver, "map_fragment", lambda mi, opt, frag: (
        host.append(frag[0].name) or map_fragment(mi, opt, frag)))
    want = io.StringIO()
    jax_engine.run_batched_pe_cli(jmi, jmo, queries, want,
                                  batch_frags=batch_frags, L=256, align_kw=KW)
    got = io.StringIO()
    engine.host_path.clear()
    res = engine.run_batched_pe_cli(pmi, pmo, queries, got,
                                    batch_frags=batch_frags, L=256,
                                    align_kw=KW, device="cpu")
    return want.getvalue(), host, got.getvalue(), res


@pytest.mark.parametrize("sam", [True, False], ids=["sam", "paf"])
def test_run_batched_pe_cli_matches_jax(monkeypatch, sam):
    flag = jax_config.MM_F_CIGAR | (jax_config.MM_F_OUT_SAM if sam else 0)
    want, host, got, (n, fallbacks) = _run_pe(monkeypatch, SR, flag)
    assert got == want
    assert n == 80 and fallbacks == [] and host == []
    lines = got.splitlines()
    assert len(lines) == 80
    if sam:
        assert all(int(t.split("\t")[1]) & 2 for t in lines)   # proper pairs


def test_run_batched_pe_cli_fallback_fragments_match_jax(monkeypatch,
                                                         tmp_path):
    """Pairs with a z-drop end, a junk end, an unmapped end and an oversize
    end among ordinary ones: the same whole fragments go to the host path,
    and the text (host records in input order) is the JAX package's.  An
    end longer than QP is not in the JAX package's fb_ids (only ends whose
    alignment failed its audit are), so both packages write it unmapped
    and its fragment stays on the device path."""
    special = {1: "oversize", 3: "zdrop", 4: "junk", 6: "unmapped",
               8: "zdrop", 9: "oversize"}
    r1, r2 = _sim_pairs(12, 7, special)
    queries = [_write_fq(tmp_path / "r1.fq", r1),
               _write_fq(tmp_path / "r2.fq", r2)]
    want, host, got, (n, fallbacks) = _run_pe(
        monkeypatch, queries, jax_config.MM_F_CIGAR | jax_config.MM_F_OUT_SAM,
        batch_frags=5)
    assert got == want
    assert n == 24
    assert fallbacks == [(r1[3][0], "zdrop")] and host == [r1[3][0]]
    assert engine.host_path["reads"] == 2
    recs = [ln.split("\t") for ln in got.splitlines()]
    order = [int(t[0][1:t[0].index("_")]) for t in recs]
    assert order == sorted(order) and len(order) == 24
    for i in (1, 9, 6):         # oversize r1, random r2: unmapped
        t = recs[2 * i + (i == 6)]
        assert int(t[1]) & 4 and len(t[9]) == (150 if i == 6 else 300)


def _cli_both(monkeypatch, tmp_path, argv):
    """cli.main(argv) of both packages at small widths, to the same -o
    path (the @PG line carries it)."""
    outs = []
    for mod, cli, kw in ((jax_engine, jax_cli, {}),
                         (engine, port_cli, {"device": "cpu"})):
        monkeypatch.setattr(mod, "run_batched_cli", functools.partial(
            mod.run_batched_cli, batch_reads=16, L=256))
        monkeypatch.setattr(mod, "run_batched_align_cli", functools.partial(
            mod.run_batched_align_cli, batch_reads=16, L=256, align_kw=KW))
        monkeypatch.setattr(mod, "run_batched_pe_cli", functools.partial(
            mod.run_batched_pe_cli, batch_frags=8, L=256, align_kw=KW))
        out = tmp_path / "out"
        assert cli.main(["--batch", *argv[:-1], "-o", str(out), MT,
                         *argv[-1]], **kw) == 0
        outs.append(out.read_text())
    return outs


@pytest.mark.parametrize("opts,files", [
    (["-x", "sr"], SR[:1]), (["-ax", "sr"], SR[:1]),
    (["-x", "sr"], SR), (["-ax", "sr"], SR)],
    ids=["paf-single", "sam-single", "paf-paired", "sam-paired"])
def test_cli_sr_matches_jax(monkeypatch, tmp_path, opts, files):
    r1, r2 = (jax_fastx.FastxReader(f) for f in SR)
    few = []
    for f, rd in zip(SR, (r1, r2)):     # the first 16 records of each file
        recs = [rd.read1() for _ in range(16)]
        few.append(_write_fq(tmp_path / f.split("/")[-1],
                             [(r.name, r.seq) for r in recs]))
    files = few[:len(files)]
    want, got = _cli_both(monkeypatch, tmp_path, [*opts, files])
    assert got == want
    lines = [ln for ln in got.splitlines() if not ln.startswith("@")]
    assert len(lines) >= 16 * len(files)
    if opts[0] == "-ax":
        assert got.startswith("@HD")
        if len(files) == 2:
            assert all(int(t.split("\t")[1]) & 1 for t in lines)
