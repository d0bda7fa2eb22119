"""The port's mappy (minimap2_tpu_torch.mappy) against the JAX package's:
the cases of tests/test_mappy.py with every Alignment field and cs/ds/MD
compared, Aligner.seq, the .npz round trip (fn_idx_out, then a .npz
target), the keyword options of Aligner.__init__ and map, and a .mmi
target, which both read as FASTA (ROADMAP Queue 3)."""
import pytest

import minimap2_tpu.mappy as jax_mp
import minimap2_tpu_torch.mappy as port_mp

DATA = "tests/data"
FIELDS = ("ctg", "ctg_len", "r_st", "r_en", "strand", "q_st", "q_en",
          "mapq", "cigar", "cigar_str", "is_primary", "mlen", "blen", "NM",
          "trans_strand", "read_num", "cs", "ds", "MD")


def _hits(aligner, *args, **kw):
    return [tuple(getattr(h, f) for f in FIELDS) + (str(h),)
            for h in aligner.map(*args, **kw)]


def _both(*args, **kw):
    return jax_mp.Aligner(*args, **kw), port_mp.Aligner(*args, **kw)


def _props(a):
    return (bool(a), a.k, a.w, a.n_seq, a.seq_names, a.map_opt.mid_occ)


def test_basics():
    ja, pa = _both(f"{DATA}/MT-human.fa", preset="map-ont")
    assert _props(pa) == _props(ja)
    for args in (("MT_human", 0, 10), ("MT_human", 16500),
                 ("MT_human", 100, 50), ("MT_human", 16569), ("nope",),
                 ("MT_human", 5, -1)):
        assert pa.seq(*args) == ja.seq(*args)
    assert port_mp.revcomp("ACGTNacgtRY") == jax_mp.revcomp("ACGTNacgtRY")
    assert port_mp.verbose() == jax_mp.verbose()


def test_map_matches_jax_mappy():
    ja, pa = _both(f"{DATA}/MT-human.fa", preset="map-ont")
    reads = list(port_mp.fastx_read(f"{DATA}/MT-orang.fa"))
    assert reads == list(jax_mp.fastx_read(f"{DATA}/MT-orang.fa"))
    name, seq, _ = reads[0]
    want = _hits(ja, seq, name=name, cs=True, ds=True, MD=True)
    assert want and _hits(pa, seq, name=name, cs=True, ds=True,
                          MD=True) == want
    # the golden primary of mt-sam (tests/test_mappy.py)
    assert want[0][2:4] == (576, 16569) and want[0][7] == 60


def test_map_paired_and_seq_index():
    ref = ("ACGTACGTGG" * 60) + ("TTGACCATGA" * 60)
    ja, pa = _both(seq=ref, preset="sr")
    assert _props(pa) == _props(ja)
    r1 = ref[50:150]
    r2 = port_mp.revcomp(ref[350:450])
    want = _hits(ja, r1, r2, name="p")
    assert {h[15] for h in want} == {1, 2}
    assert _hits(pa, r1, r2, name="p") == want
    assert _hits(pa, r1, r2, name="p", max_frag_len=300) == \
        _hits(ja, r1, r2, name="p", max_frag_len=300)


def test_fastx_read_fastq_comment():
    for kw in ({}, {"read_comment": True}):
        want = list(jax_mp.fastx_read(f"{DATA}/sr-r1.fq", **kw))
        assert len(want) == 40
        assert list(port_mp.fastx_read(f"{DATA}/sr-r1.fq", **kw)) == want


@pytest.mark.parametrize("kw", [
    dict(preset="splice", extra_flags=0x4000000),
    dict(k=17, w=11, min_cnt=2, min_chain_score=30, min_dp_score=50,
         bw=300, bw_long=5000, best_n=2, max_chain_skip=10),
    dict(preset="map-ont", scoring=[1, 2, 2, 1, 32, 0, 2], sc_ambi=3),
    dict(preset="asm5", scoring=[1, 4, 6, 2]),
], ids=["splice", "chain-opts", "scoring7", "scoring4"])
def test_aligner_options_match_jax(kw):
    ja, pa = _both(f"{DATA}/MT-human.fa", **kw)
    assert _props(pa) == _props(ja)
    assert vars(pa.map_opt) == vars(ja.map_opt) | {"dbg_flag": 0}
    name, seq, _ = next(jax_mp.fastx_read(f"{DATA}/MT-orang.fa"))
    sub = seq[2000:9000]
    assert _hits(pa, sub, name=name, cs=True, extra_flags=0x80000) == \
        _hits(ja, sub, name=name, cs=True, extra_flags=0x80000)


def test_npz_round_trip(tmp_path):
    jnpz, pnpz = tmp_path / "j.npz", tmp_path / "p.npz"
    jax_mp.Aligner(f"{DATA}/MT-human.fa", preset="map-ont",
                   fn_idx_out=str(jnpz))
    pa = port_mp.Aligner(f"{DATA}/MT-human.fa", preset="map-ont",
                         fn_idx_out=str(pnpz))
    ja2 = jax_mp.Aligner(str(jnpz), preset="map-ont")
    pa2 = port_mp.Aligner(str(pnpz), preset="map-ont")
    assert _props(pa2) == _props(ja2) == _props(pa)
    assert pa2.seq("MT_human", 100, 200) == ja2.seq("MT_human", 100, 200)
    name, seq, _ = next(port_mp.fastx_read(f"{DATA}/MT-orang.fa"))
    assert _hits(pa2, seq, name=name, MD=True) == \
        _hits(ja2, seq, name=name, MD=True) == _hits(pa, seq, name=name,
                                                     MD=True)


def test_mmi_target_is_read_as_fasta(tmp_path):
    """A .mmi target goes to the FASTA reader in both packages, which
    rejects it; the reference mappy would load it as an index."""
    from minimap2_tpu_torch import cli
    mmi = tmp_path / "mt.mmi"
    assert cli.main(["-d", str(mmi), f"{DATA}/MT-human.fa"],
                    device="cpu") == 0
    errs = []
    for mp in (jax_mp, port_mp):
        with pytest.raises(ValueError) as e:
            mp.Aligner(str(mmi), preset="map-ont")
        errs.append(str(e.value))
    assert errs[0] == errs[1] == "malformed FASTA/FASTQ input"
