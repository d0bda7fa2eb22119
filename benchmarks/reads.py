"""The benchmark's read models, drawn on the device from the genome.

``ont``: the ONT-like model of the port's chip smoke run (8-11 kb, 5%
substitutions, 2.5% deletions, then 2.5% insertions; every other read from
the minus strand), from the big chromosomes.  ``sr``: its Illumina-like FR
pairs (fragments N(350, 50) clipped to [200, 600], 2 x 150 bp, 0.5%
substitutions, 0.01% deletions and insertions; every other fragment from
the minus strand), from every contig by length.

Each model returns host nt4 code arrays and the truth of every read:
(contig index, start, end, strand) of the bases it was drawn from.
"""
from __future__ import annotations

import numpy as np
import torch

ACGT = np.frombuffer(b"ACGTN", np.uint8)


def _mutate(rows, lens, gen, sub, dele, ins):
    """Apply substitutions, then deletions, then insertions (on the bases
    left) to (n, W) code rows of the given lengths; returns (rows, lens)
    of the results, padded with 4."""
    n, W = rows.shape
    dev = rows.device
    col = torch.arange(W, device=dev)[None, :]
    live = col < lens[:, None]
    r = torch.rand((n, W), generator=gen, device=dev)
    shift = torch.randint(1, 4, (n, W), generator=gen, device=dev,
                          dtype=torch.uint8)
    rows = torch.where(r < sub, (rows + shift) % 4, rows)
    keep = live & ~((r >= sub) & (r < sub + dele))
    r2 = torch.rand((n, W), generator=gen, device=dev)
    extra = torch.randint(0, 4, (n, W), generator=gen, device=dev,
                          dtype=torch.uint8)
    add = keep & (r2 < ins)
    emit = keep.to(torch.int64) + add.to(torch.int64)
    end = torch.cumsum(emit, 1)             # one past each kept base
    out_len = end[:, -1]
    Wo = int(out_len.max()) if n else 0
    out = torch.full((n, max(Wo, 1)), 4, dtype=torch.uint8, device=dev)
    ri = torch.arange(n, device=dev)[:, None].expand(n, W)
    out[ri[keep], end[keep] - 1] = rows[keep]
    out[ri[add], end[add] - 2] = extra[add]
    return out, out_len


def _revcomp(rows, lens):
    """Reverse complement of each row's first lens[i] codes."""
    n, W = rows.shape
    col = torch.arange(W, device=rows.device)[None, :]
    src = torch.clamp(lens[:, None] - 1 - col, min=0)
    rc = 3 - torch.gather(rows, 1, src)
    return torch.where(col < lens[:, None], rc, torch.full_like(rows, 4))


def _to_host(rows, lens):
    rows, lens = rows.cpu().numpy(), lens.cpu().numpy()
    return [rows[i, :lens[i]].copy() for i in range(len(lens))]


def ont(parts, n_big, n_reads, gen, min_len=8000, max_len=11000, sub=0.05,
        dele=0.025, ins=0.025):
    """(codes, truth) of n_reads ONT-like reads from parts[:n_big]."""
    dev = parts[0].device
    per = torch.tensor([int(p.shape[0]) for p in parts[:n_big]], device=dev)
    ci = torch.randint(0, n_big, (n_reads,), generator=gen, device=dev)
    ln = torch.randint(min_len, max_len, (n_reads,), generator=gen,
                       device=dev)
    st = (torch.rand(n_reads, generator=gen, device=dev, dtype=torch.float64)
          * (per[ci] - ln)).to(torch.int64)
    rows = torch.empty((n_reads, max_len), dtype=torch.uint8, device=dev)
    col = torch.arange(max_len, device=dev)
    for c in range(n_big):
        sel = torch.nonzero(ci == c).squeeze(1)
        if sel.numel():
            idx = torch.clamp(st[sel, None] + col[None, :], max=parts[c]
                              .shape[0] - 1)
            rows[sel] = parts[c][idx]
    out, olen = _mutate(rows, ln, gen, sub, dele, ins)
    minus = (torch.arange(n_reads, device=dev) % 2) == 1
    out = torch.where(minus[:, None], _revcomp(out, olen), out)
    truth = np.stack([x.cpu().numpy() for x in
                      (ci, st, st + ln, minus.to(torch.int64))], 1)
    return _to_host(out, olen), truth


SR_LEN = 150


def sr(parts, n_pairs, gen, sub=0.005, dele=0.0001, ins=0.0001):
    """(r1 codes, r2 codes, truth) of n_pairs FR pairs; truth rows are
    (contig, fragment start, fragment end, fragment on the minus strand)."""
    dev = parts[0].device
    plen = torch.tensor([int(p.shape[0]) for p in parts], device=dev,
                        dtype=torch.float64)
    ci = torch.multinomial(plen / plen.sum(), n_pairs, replacement=True,
                           generator=gen)
    flen = torch.clamp(torch.round(350 + 50 * torch.randn(
        n_pairs, generator=gen, device=dev, dtype=torch.float64)),
        200, 600).to(torch.int64)
    st = (torch.rand(n_pairs, generator=gen, device=dev, dtype=torch.float64)
          * (plen[ci].to(torch.int64) - flen)).to(torch.int64)
    FW = 600
    frag = torch.empty((n_pairs, FW), dtype=torch.uint8, device=dev)
    col = torch.arange(FW, device=dev)
    for c in range(len(parts)):
        sel = torch.nonzero(ci == c).squeeze(1)
        if sel.numel():
            idx = torch.clamp(st[sel, None] + col[None, :],
                              max=parts[c].shape[0] - 1)
            frag[sel] = parts[c][idx]
    minus = (torch.arange(n_pairs, device=dev) % 2) == 1
    frag = torch.where(minus[:, None], _revcomp(frag, flen), frag)
    e1 = frag[:, :SR_LEN]
    tail = torch.gather(frag, 1, flen[:, None] - SR_LEN
                        + torch.arange(SR_LEN, device=dev)[None, :])
    e2 = _revcomp(tail, torch.full((n_pairs,), SR_LEN, device=dev))
    full = torch.full((n_pairs,), SR_LEN, device=dev)
    r1, l1 = _mutate(e1.contiguous(), full, gen, sub, dele, ins)
    r2, l2 = _mutate(e2.contiguous(), full, gen, sub, dele, ins)
    truth = np.stack([x.cpu().numpy() for x in
                      (ci, st, st + flen, minus.to(torch.int64))], 1)
    return _to_host(r1, l1), _to_host(r2, l2), truth


def sr_end_truth(row, end: int):
    """(contig, start, end, minus) of end 1 or 2 of a pair's truth row: r1
    is the fragment's start on its strand, r2 its end on the other."""
    c, st, en, minus = (int(x) for x in row)
    first = (not minus) == (end == 1)
    s, e = (st, st + SR_LEN) if first else (en - SR_LEN, en)
    return c, s, e, int(minus) ^ (end == 2)


def write_fasta(path, names, codes):
    with open(path, "wb") as f:
        for nm, x in zip(names, codes):
            f.write(b">%s\n%s\n" % (nm.encode(), ACGT[x].tobytes()))
