"""The benchmark's synthetic reference genome, made on the device.

The design is the GRCh38 envelope of the port's utils/simgenome_dev.py
(24 chromosomes holding 97% of the bases, the rest in small alt/unplaced
contigs; LINE-like, Alu-like and satellite copies and segmental
duplications), drawn with torch's own generator on the device instead of a
bit-exact threefry, so a whole genome takes seconds.  The same seed gives
the same genome on the same device type.

Every contig is a view of one flat uint8 tensor of nt4 codes (0-3), so a
caller that drops its list of views frees the genome.
"""
from __future__ import annotations

import numpy as np
import torch

LINE_LEN, ALU_LEN, SAT_LEN = 6000, 300, 171


def plan(total: int, n_contigs: int, n_big: int = 24,
         big_frac: float = 0.97):
    """[(name, length)]: n_big chromosomes sharing big_frac of ``total``,
    then n_contigs - n_big alt contigs sharing the rest (at least 4096
    bases each)."""
    n_big = min(n_big, n_contigs)
    n_small = n_contigs - n_big
    big = int(total * big_frac) // n_big
    out = [(f"chr{i + 1}", big) for i in range(n_big)]
    if n_small > 0:
        small = max(int(total * (1 - big_frac)) // n_small, 4096)
        out += [(f"alt{i}", small) for i in range(n_small)]
    return out


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one purpose (salt) of a seed;
    any whole number seeds it."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), seed >> 64, salt])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1))
    return g


def _paste(g, gen, template, starts, lens, div):
    """Paste mutated copies of ``template`` into the contig g: copy i is
    template[T - lens[i]:] at starts[i] (5'-truncated), each base replaced
    by a random one with probability div[i]; a later copy wins where
    copies overlap (a max-combining scatter of the copy's rank)."""
    T = template.shape[0]
    dev = g.device
    n = starts.shape[0]
    if n == 0:
        return
    col = torch.arange(T, device=dev)
    valid = col[None, :] >= (T - lens)[:, None]
    i, j = torch.nonzero(valid, as_tuple=True)
    mut = torch.rand(i.shape[0], generator=gen, device=dev) < div[i]
    rnd = torch.randint(0, 4, (i.shape[0],), generator=gen, device=dev,
                        dtype=torch.uint8)
    code = torch.where(mut, rnd, template[j])
    pos = starts[i] + j
    pri = ((i.to(torch.int32) + 1) << 2) | code.to(torch.int32)
    buf = torch.zeros(g.shape[0], dtype=torch.int32, device=dev)
    buf.scatter_reduce_(0, pos, pri, reduce="amax")
    hit = buf > 0
    g[hit] = (buf[hit] & 3).to(torch.uint8)


def _contig(g, gen, masters):
    """Repeat structure of one contig, in place (simgenome_dev's rates)."""
    line, alu, sat = masters
    P = g.shape[0]
    dev = g.device

    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    def ri(n, lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    # LINE-like: ~18% of the contig, 5'-truncated copies at 80-95% identity
    n = int(P * 0.18 / 3200)
    if P > LINE_LEN and n:
        _paste(g, gen, line, ri(n, 0, P - LINE_LEN), ri(n, 500, LINE_LEN + 1),
               u(n, 0.05, 0.20))
    # Alu-like: ~10% at 85-95% identity
    n = int(P * 0.10 / ALU_LEN)
    if P > ALU_LEN and n:
        _paste(g, gen, alu, ri(n, 0, P - ALU_LEN),
               torch.full((n,), ALU_LEN, device=dev), u(n, 0.05, 0.15))
    # 25 centromeric satellite arrays of 60-600 monomers, 3% divergence
    max_rep = 600
    SL = max_rep * SAT_LEN
    if P > SL:
        reps = ri(25, 60, max_rep + 1)
        cen = torch.clamp(P // 2 + ri(25, -(P // 20), P // 20), 0, P - SL)
        _paste(g, gen, sat.repeat(max_rep), cen, reps * SAT_LEN,
               torch.full((25,), 0.03, device=dev))
    # 10 segmental duplications of 20-100 kb at ~95% identity, in order
    DL = 100_000
    if P > DL:
        lens = ri(10, 20_000, DL).tolist()
        src = ri(10, 0, P - DL).tolist()
        dst = ri(10, 0, P - DL).tolist()
        for Lb, s, d in zip(lens, src, dst):
            mut = torch.rand(Lb, generator=gen, device=dev) < 0.05
            rnd = torch.randint(0, 4, (Lb,), generator=gen, device=dev,
                                dtype=torch.uint8)
            g[d:d + Lb] = torch.where(mut, rnd, g[s:s + Lb])


def make(seed: int, total: int, n_contigs: int, device, n_big: int = 24):
    """(names, parts): the genome of ``seed``, each part a uint8 view of
    one flat tensor on ``device``."""
    gen = generator(seed, 0x6E0, device)
    contigs = plan(total, n_contigs, n_big)
    lens = [ln for _, ln in contigs]
    flat = torch.randint(0, 4, (sum(lens),), generator=gen, device=device,
                         dtype=torch.uint8)
    masters = tuple(torch.randint(0, 4, (n,), generator=gen, device=device,
                                  dtype=torch.uint8)
                    for n in (LINE_LEN, ALU_LEN, SAT_LEN))
    parts, off = [], 0
    for ln in lens:
        g = flat[off:off + ln]
        _contig(g, gen, masters)
        parts.append(g)
        off += ln
    return [nm for nm, _ in contigs], parts
