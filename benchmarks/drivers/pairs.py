"""`minimap2 -ax sr r1 r2`: engine.align_pairs, both ends mapped and
aligned on the device, then mm_pair on the host.  A client passes its
pool's two files through one call after another."""
from __future__ import annotations

from benchmarks import reads

UNIT_READS = 2


def pool(cell, client: int, gen):
    t = cell.traffic
    r1, r2, truth = reads.sr(cell.parts, t["pool"], gen,
                             **t.get("read_model", {}))
    names = [f"c{client}p{i}" for i in range(len(r1))]
    files = []
    for e, codes in ((1, r1), (2, r2)):
        path = cell.tmp / f"c{client}_{e}.fa"
        reads.write_fasta(path, names, codes)
        files.append(str(path))
    return dict(names=names, files=files, reads=list(zip(r1, r2)),
                truths=[[reads.sr_end_truth(row, 1),
                         reads.sr_end_truth(row, 2)] for row in truth])


def client(cell, pl):
    """A callable that maps, aligns and pairs the pool until the sink
    closes: the mapping step at the configuration's widths (``step``), the
    rest of BatchParams from the options and the index as the CLI's
    paired-end path takes them."""
    from minimap2_tpu_torch.config import MM_I_HPC
    from minimap2_tpu_torch.parallel import engine
    from minimap2_tpu_torch.parallel.align_batch import AlignBatcher
    from minimap2_tpu_torch.parallel.batch import BatchParams
    opt, mi, c = cell.opt, cell.mi, cell.config
    p = BatchParams(**c["step"], occ_cap=engine._occ_cap(opt), k=mi.k,
                    w=mi.w, max_dist_x=opt.max_gap, max_dist_y=opt.max_gap,
                    bw=opt.bw, hpc=bool(mi.flag & MM_I_HPC))
    sec = opt.best_n > 0 and opt.pri_ratio > 0
    step = engine.PafStep(cell.di, p, K=3 if sec else 1,
                          min_sc=opt.min_chain_score, with_sec=sec)
    ab = AlignBatcher(mi, opt, device=cell.device, **c["align"])

    def run(sink):
        while True:
            engine.align_pairs(step, ab, mi, opt, pl["files"], sink,
                               cell.traffic["batch"])
    return run
