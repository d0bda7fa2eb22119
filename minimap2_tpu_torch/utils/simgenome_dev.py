"""Synthetic genome and read slicing on the device (the counterpart of
minimap2_tpu.utils.simgenome_dev).

The benchmark genomes (100 Mb to the 3.1 Gb GRCh38 envelope) are made
where they are indexed: the LINE / Alu / satellite / segmental-duplication
repeat structure of utils/simgenome.py, drawn with JAX's threefry PRNG as
reproduced in utils/jrandom.py.  The same (total, n_chrom, seed) gives the
JAX package's genome byte for byte, on any device, so the CPU regenerates
what the card holds (``write_genome_fasta_host``, ``simulate_contig``)
without copying it back.  Only the sampled reads leave the device.

Every key derives from one PRNGKey(seed), with fold_in per chromosome, as
in the JAX package.  Overlapping repeat pastes resolve by copy priority
(the later copy wins) through a max-combining scatter.
"""
from __future__ import annotations

import numpy as np
import torch

from . import jrandom as jr


def _paste_copies(g, key, row, starts, div, valid):
    """Paste mutated copies of ``row`` (the (L,) template of every copy)
    at starts, the later copy winning where copies overlap: the JAX
    package's ``_paste_max(g, starts, _mutate(key, copies, div), valid)``
    with copies = row broadcast to valid's (n, L).  Only the columns that
    are pasted are drawn (threefry counts flat positions, so a position's
    draw does not depend on which others are taken); a max-combining
    scatter (deterministic with duplicate targets) gives the priority."""
    L = valid.shape[1]
    f = torch.nonzero(valid.reshape(-1)).squeeze(1)
    i, j = f // L, f % L
    k1, k2 = jr.split(key)
    dev = g.device
    m = jr.uniform(k1, valid.shape, device=dev, at=f) < div[i]
    code = torch.where(m, jr.randint(k2, valid.shape, 0, 4, torch.uint8,
                                     device=dev, at=f), row[j])
    pos = starts.to(torch.int64)[i] + j
    pri = ((i.to(torch.int32) + 1) << 2) | code.to(torch.int32)
    keep = (pos >= 0) & (pos < g.shape[0])          # mode="drop"
    buf = torch.zeros(g.shape, dtype=torch.int32, device=dev)
    buf.scatter_reduce_(0, pos[keep], pri[keep], reduce="amax")
    return torch.where(buf > 0, (buf & 3).to(torch.uint8), g)


def _masters(seed: int, device):
    """The LINE, Alu and satellite master sequences of a genome seed."""
    km = jr.split(jr.fold_in(jr.PRNGKey(seed), 0xA11), 3)
    return tuple(jr.randint(k, (n,), 0, 4, torch.uint8, device=device)
                 for k, n in zip(km, (6000, 300, 171)))


def _sim_chrom_dev(key, line_master, alu_master, sat_master, P: int):
    """One chromosome of P bases (simgenome_dev._sim_chrom_dev)."""
    dev = line_master.device
    ks = jr.split(key, 12)
    g = jr.randint(ks[0], (P,), 0, 4, torch.uint8, device=dev)
    # LINE-like: ~18%, 5'-truncated copies at 80-95% identity
    n_line = int(P * 0.18 / 3200)
    LB = 6000
    lens = jr.randint(ks[1], (n_line,), 500, LB + 1, device=dev)
    col = torch.arange(LB, dtype=torch.int32, device=dev)[None, :]
    div = jr.uniform(ks[3], (n_line,), 0.05, 0.20, device=dev)
    st = jr.randint(ks[4], (n_line,), 0, P - LB, device=dev)
    g = _paste_copies(g, ks[2], line_master, st, div,
                      col >= (LB - lens)[:, None])
    # Alu-like: ~10% at 85-95% identity
    n_alu = int(P * 0.10 / 300)
    div = jr.uniform(ks[6], (n_alu,), 0.05, 0.15, device=dev)
    st = jr.randint(ks[7], (n_alu,), 0, P - 300, device=dev)
    g = _paste_copies(g, ks[5], alu_master, st, div,
                      torch.ones((n_alu, 300), dtype=torch.bool, device=dev))
    # centromeric satellite arrays (171 bp monomer tandems)
    n_arr, max_rep = 25, 600
    SL = max_rep * 171
    reps = jr.randint(ks[8], (n_arr,), 60, max_rep + 1, device=dev)
    cen = P // 2 + jr.randint(ks[10], (n_arr,), -P // 20, P // 20,
                              device=dev)
    cen = torch.clamp(cen, 0, P - SL)
    vm = torch.arange(SL, dtype=torch.int32, device=dev)[None, :] \
        < (reps * 171)[:, None]
    g = _paste_copies(g, ks[9], sat_master.repeat(max_rep), cen,
                      torch.full((n_arr,), 0.03, dtype=torch.float32,
                                 device=dev), vm)
    # segmental duplications: 10 blocks of 20-100 kb at ~95% identity,
    # in order (each block reads the genome the previous one wrote); only
    # a block's first Lb positions are drawn and written
    DL = 100_000
    cut = torch.tensor(0.05, dtype=torch.float32, device=dev)
    for kk in jr.split(ks[11], 10):
        k1, k2, k3, k4, k5 = jr.split(kk, 5)
        Lb = jr.randint_scalar(k1, 20_000, DL)
        # lax.dynamic_slice clamps its start into [0, P - DL]
        src = min(max(jr.randint_scalar(k2, 0, P - DL), 0), P - DL)
        dst = min(max(jr.randint_scalar(k3, 0, P - DL), 0), P - DL)
        m = jr.uniform(k4, (Lb,), device=dev) < cut
        g[dst:dst + Lb] = torch.where(
            m, jr.randint(k5, (Lb,), 0, 4, torch.uint8, device=dev),
            g[src:src + Lb])
    return g


def simulate_genome_device(total_len: int = 1_000_000_000, n_chrom: int = 8,
                           seed: int = 7, device=None):
    """(names, [uint8 nt4 tensors on ``device``]): n_chrom chromosomes of
    total_len // n_chrom bases each."""
    from .. import resolve_device
    dev = resolve_device(device)
    masters = _masters(seed, dev)
    root = jr.PRNGKey(seed)
    per = total_len // n_chrom
    names, parts = [], []
    for c in range(n_chrom):
        parts.append(_sim_chrom_dev(jr.fold_in(root, c + 1), *masters, P=per))
        names.append(f"chr{c + 1}")
    return names, parts


def simulate_contig(seed: int, c: int, P: int, device=None):
    """Chromosome c (0-based) of the genome of ``seed`` with P bases a
    chromosome, alone: the same bytes as simulate_genome_device's part c,
    on any device."""
    from .. import resolve_device
    dev = resolve_device(device)
    return _sim_chrom_dev(jr.fold_in(jr.PRNGKey(seed), c + 1),
                          *_masters(seed, dev), P=P)


def grch38_parts_plan(total: int = 3_100_000_000, ncon: int = 195):
    """The envelope's two genomes as (total_len, n_chrom, seed): 24 big
    chromosomes with 97% of ``total`` (seed 7) and ncon - 24 small
    alt/unplaced contigs sharing 3% (seed 8)."""
    return ((int(total * 0.97), 24, 7),
            (max(int(total * 0.03), (ncon - 24) * 4096), ncon - 24, 8))


def grch38_envelope_parts(total: int = 3_100_000_000, ncon: int = 195,
                          device=None):
    """The GRCh38-shaped benchmark genome (simgenome_dev.
    grch38_envelope_parts): returns (names, parts).  The returned list
    holds the only references, so build_device_index(consume=True) frees
    each contig as it copies it."""
    (tb, nb, sb), (ts, ns, ss) = grch38_parts_plan(total, ncon)
    big = simulate_genome_device(tb, nb, sb, device)
    small = simulate_genome_device(ts, ns, ss, device)
    names = big[0] + [f"alt{i}" for i in range(len(small[1]))]
    parts = big[1] + small[1]
    big[1].clear()
    small[1].clear()
    return names, parts


def _slice_reads(flat, starts, RL: int):
    """Rows flat[starts[i] : starts[i] + RL]; positions past the end read
    the last base (a gather with clamped indices, as XLA's)."""
    idx = starts.to(torch.int64)[:, None] \
        + torch.arange(RL, device=flat.device)[None, :]
    return flat[torch.clamp(idx, 0, flat.shape[0] - 1)]


def _rows_per_contig(parts, ci, st, width):
    """The (n, width) host rows of each read's source interval, sliced
    contig by contig on the device (int64 indices: a flat concatenation
    would pass 2^31 for genomes of more than 2 Gb)."""
    raw = np.zeros((len(ci), width), np.uint8)
    for c in range(len(parts)):
        sel = np.flatnonzero(ci == c)
        if len(sel):
            stp = torch.from_numpy(st[sel].astype(np.int64)) \
                .to(parts[c].device)
            raw[sel] = _slice_reads(parts[c], stp, width).cpu().numpy()
    return raw


def write_genome_fasta_host(path, total_len: int, n_chrom: int, seed: int):
    """Regenerate the device genome on the CPU and write it as FASTA
    (threefry gives the same bytes on every device)."""
    from .simgenome import write_fasta
    names, parts = simulate_genome_device(total_len, n_chrom, seed, "cpu")
    write_fasta(path, names, [p.numpy() for p in parts])
    return names


def satellite_regions(P: int, n_chrom: int, seed: int = 7, device="cpu"):
    """The (centres, lengths) of each chromosome's 25 centromeric
    satellite arrays, recomputed from _sim_chrom_dev's PRNG stream
    without making the genome."""
    root = jr.PRNGKey(seed)
    n_arr, max_rep = 25, 600
    out = []
    for c in range(n_chrom):
        ks = jr.split(jr.fold_in(root, c + 1), 12)
        reps = jr.randint(ks[8], (n_arr,), 60, max_rep + 1, device=device)
        cen = P // 2 + jr.randint(ks[10], (n_arr,), -P // 20, P // 20,
                                  device=device)
        cen = torch.clamp(cen, 0, P - max_rep * 171)
        out.append((cen.cpu().numpy().astype(np.int64),
                    reps.cpu().numpy().astype(np.int64) * 171))
    return out


def simulate_reads_device(parts, n_reads: int, seed: int = 1,
                          min_len: int = 8000, max_len: int = 11000,
                          sub: float = 0.05, dele: float = 0.025,
                          ins: float = 0.025, names=None,
                          region: str | None = None,
                          genome_seed: int = 7):
    """Reads sliced from the device genome (only ~n_reads * max_len bytes
    come back): the error model (sub/del/ins, alternating strand) and the
    mapeval truth names of utils/simgenome.simulate_reads.
    region='satellite' starts reads inside the centromeric tandem arrays
    (satellite_regions) instead of uniformly."""
    n_chrom = len(parts)
    per = int(parts[0].shape[0])
    rng = np.random.default_rng(seed)
    ci = rng.integers(0, n_chrom, n_reads)
    ln = rng.integers(min_len, max_len, n_reads)
    if region == "satellite":
        regs = satellite_regions(per, n_chrom, genome_seed)
        ai = rng.integers(0, len(regs[0][0]), n_reads)
        cen = np.array([regs[c][0][a] for c, a in zip(ci, ai)])
        al = np.array([regs[c][1][a] for c, a in zip(ci, ai)])
        span = np.maximum(al - ln, 1)
        st = (cen + rng.random(n_reads) * span).astype(np.int64)
        st = np.minimum(st, per - ln - 1)
    else:
        st = (rng.random(n_reads) * (per - ln)).astype(np.int64)
    raw = _rows_per_contig(parts, ci, st, max_len)
    names_out, out = [], []
    for i in range(n_reads):
        src = raw[i, :ln[i]].astype(np.uint8)
        r = rng.random(int(ln[i]))
        s = src.copy()
        msub = r < sub
        s[msub] = (s[msub] + rng.integers(1, 4, int(msub.sum()),
                                          dtype=np.uint8)) % 4
        mdel = (r >= sub) & (r < sub + dele)
        s = s[~mdel]
        r2 = rng.random(len(s))
        mins = r2 < ins
        extra = rng.integers(0, 4, int(mins.sum())).astype(np.uint8)
        s = np.insert(s, np.flatnonzero(mins), extra)
        strand = "+"
        if i % 2:
            s = (3 - s)[::-1].astype(np.uint8)
            strand = "-"
        cname = names[ci[i]] if names else f"chr{ci[i] + 1}"
        names_out.append(f"S1_{i}!{cname}!{st[i]}!{st[i] + ln[i]}!{strand}")
        out.append(s)
    return names_out, out


def simulate_reads_device_clr(parts, n_reads: int, seed: int = 97,
                              mean_len: int = 20000, sd_len: int = 4000,
                              min_len: int = 12000, max_len: int = 30000,
                              err: float = 0.05, sv_frac: float = 0.1,
                              names=None):
    """The off-distribution read set: pbsim-CLR-shaped reads (normal
    lengths around 20 kb, sub:ins:del = 10:60:30, random strand, and
    sv_frac of the reads carrying one 1-10 kb internal deletion).  The
    truth interval is the whole source span, the deleted part included."""
    n_chrom = len(parts)
    per = int(parts[0].shape[0])
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC1B]))
    ln = np.clip(rng.normal(mean_len, sd_len, n_reads), min_len,
                 max_len).astype(np.int64)
    sv_del = np.where(rng.random(n_reads) < sv_frac,
                      rng.integers(1000, 10000, n_reads), 0)
    span = ln + sv_del
    ci = rng.integers(0, n_chrom, n_reads)
    st = (rng.random(n_reads) * (per - span)).astype(np.int64)
    raw = _rows_per_contig(parts, ci, st, int(span.max()))
    sub, ins, dele = err * 0.1, err * 0.6, err * 0.3
    names_out, out = [], []
    for i in range(n_reads):
        src = raw[i, :span[i]].astype(np.uint8)
        if sv_del[i]:
            mid = int(span[i]) // 2
            src = np.concatenate([src[:mid], src[mid + int(sv_del[i]):]])
        r = rng.random(len(src))
        s = src.copy()
        msub = r < sub
        s[msub] = (s[msub] + rng.integers(1, 4, int(msub.sum()),
                                          dtype=np.uint8)) % 4
        mdel = (r >= sub) & (r < sub + dele)
        s = s[~mdel]
        r2 = rng.random(len(s))
        mins = r2 < ins
        extra = rng.integers(0, 4, int(mins.sum())).astype(np.uint8)
        s = np.insert(s, np.flatnonzero(mins), extra)
        strand = "+"
        if rng.random() < 0.5:
            s = (3 - s)[::-1].astype(np.uint8)
            strand = "-"
        cname = names[ci[i]] if names else f"chr{ci[i] + 1}"
        names_out.append(
            f"C1_{i}!{cname}!{st[i]}!{st[i] + span[i]}!{strand}")
        out.append(s)
    return names_out, out
