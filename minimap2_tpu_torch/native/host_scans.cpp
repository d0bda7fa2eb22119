// Host scans of the --batch -c/-a path and the FASTA/FASTQ reader (copied
// from minimap2_tpu/native/mmtpu.cpp: mm_zdrop_scan :1707,
// mm_update_extra_scan :1755, mm_fastx_scan :1856, mm_cigar_kadane_trim
// :1982 and the mg_log2f helper :1202).
// Built with g++ into build/minimap2_tpu_torch/ at first use and bound with
// ctypes by minimap2_tpu_torch/native/__init__.py.
#include <cstdint>
#include <cstring>

static inline float mg_log2f(float x)
{
    uint32_t zi;
    std::memcpy(&zi, &x, 4);
    float log2i = (float)(int)((zi >> 23 & 255) - 128);
    zi = (zi & 0x007FFFFFu) | (127u << 23);
    float zf;
    std::memcpy(&zf, &zi, 4);
    return log2i + ((-0.34484843f * zf + 2.02466578f) * zf - 0.67487759f);
}

extern "C" {

// mm_test_zdrop scan (align.c:61-103, up to but excluding the inversion
// rescue): walks the cigar accumulating the running score max and the
// deepest gap-penalised drop.  Writes [max_zdrop, pi0, pi1, pj0, pj1].
void mm_zdrop_scan(const uint8_t *qseq, const uint8_t *tseq,
                   const uint32_t *cigar, int64_t n_cigar,
                   const int8_t *mat, int m, int q, int e,
                   int64_t *out)
{
    long long mx = -(1LL << 31); long long mi = -1, mj = -1;
    long long max_zdrop = 0;
    long long p00 = -1, p01 = -1, p10 = -1, p11 = -1;
    long long score = 0, i = 0, j = 0;
    for (int64_t k = 0; k < n_cigar; ++k) {
        uint32_t c = cigar[k];
        int op = c & 0xF; long long ln = c >> 4;
        if (op == 0) {
            for (long long l = 0; l < ln; ++l) {
                score += mat[(int)tseq[i + l] * m + (int)qseq[j + l]];
                long long ci = i + l, cj = j + l;
                if (score < mx) {
                    long long li = ci - mi, lj = cj - mj;
                    long long diff = li > lj ? li - lj : lj - li;
                    long long z = mx - score - diff * e;
                    if (z > max_zdrop) {
                        max_zdrop = z;
                        p00 = mi; p01 = ci; p10 = mj; p11 = cj;
                    }
                } else { mx = score; mi = ci; mj = cj; }
            }
            i += ln; j += ln;
        } else if (op == 1 || op == 2 || op == 3) {
            score -= (long long)q + (long long)e * ln;
            if (op == 1) j += ln; else i += ln;
            if (score < mx) {
                long long li = i - mi, lj = j - mj;
                long long diff = li > lj ? li - lj : lj - li;
                long long z = mx - score - diff * e;
                if (z > max_zdrop) {
                    max_zdrop = z;
                    p00 = mi; p01 = i; p10 = mj; p11 = j;
                }
            } else { mx = score; mi = i; mj = j; }
        }
    }
    out[0] = max_zdrop; out[1] = p00; out[2] = p01;
    out[3] = p10; out[4] = p11;
}

// mm_update_extra stats (align.c:254-303 minus mm_fix_cigar): one pass over
// the cigar computing blen/mlen/n_ambi/dp_max and the spliced flag.
// out = [blen, mlen, n_ambi, dp_max, is_spliced]
void mm_update_extra_scan(const uint8_t *qseq, const uint8_t *tseq,
                          const uint32_t *cigar, int64_t n_cigar,
                          const int8_t *mat, int m, int q, int e,
                          int log_gap, int64_t *out)
{
    double s = 0.0, mxs = 0.0;
    long long blen = 0, mlen = 0, n_ambi = 0, spliced = 0;
    long long toff = 0, qoff = 0;
    for (int64_t k = 0; k < n_cigar; ++k) {
        uint32_t c = cigar[k];
        int op = c & 0xF; long long ln = c >> 4;
        if (op == 0) {
            long long na = 0, nd = 0;
            for (long long l = 0; l < ln; ++l) {
                int ct = tseq[toff + l], cq = qseq[qoff + l];
                if (ct > 3 || cq > 3) ++na;
                else if (ct != cq) ++nd;
                s += (double)mat[ct * m + cq];
                if (s < 0.0) s = 0.0;
                else if (s > mxs) mxs = s;
            }
            blen += ln - na;
            mlen += ln - (na + nd);
            n_ambi += na;
            toff += ln; qoff += ln;
        } else if (op == 1) {
            long long na = 0;
            for (long long l = 0; l < ln; ++l) if (qseq[qoff + l] > 3) ++na;
            blen += ln - na; n_ambi += na;
            if (log_gap) s -= (double)q + (double)e
                * (double)mg_log2f((float)(1.0 + (double)ln));
            else s -= (double)(q + e);
            if (s < 0.0) s = 0.0;
            qoff += ln;
        } else if (op == 2) {
            long long na = 0;
            for (long long l = 0; l < ln; ++l) if (tseq[toff + l] > 3) ++na;
            blen += ln - na; n_ambi += na;
            if (log_gap) s -= (double)q + (double)e
                * (double)mg_log2f((float)(1.0 + (double)ln));
            else s -= (double)(q + e);
            if (s < 0.0) s = 0.0;
            toff += ln;
        } else if (op == 3) {
            spliced = 1;
            toff += ln;
        }
    }
    out[0] = blen; out[1] = mlen; out[2] = n_ambi;
    out[3] = (long long)(mxs + 0.499);
    out[4] = spliced;
}

// ---------------------------------------------------------------------
// Max-scoring sub-path trim of a forced global alignment (Kadane over
// per-step score deltas).  The batch device path aligns the whole
// extended chain extent in one global band; the reference instead STOPS
// its left/right extensions at the max-score position (align.c:779-890,
// ksw mqe/mte logic).  Trimming the forced path at its own maximal
// window reproduces that stop on the fixed path: junk ends fall off,
// real alignment is kept.  M runs may split at base granularity; I/D/N
// runs are atomic with penalty min(q+l*e, q2+l*e2).
// out8: {q0, t0, q1, t1, best_score, n_cigar_out, 0, 0}; the trimmed
// cigar (merged ops) is written to cigar_out (cap >= n_cigar + 2).
// ---------------------------------------------------------------------
void mm_cigar_kadane_trim(const uint8_t* qseq, const uint8_t* tseq,
                          const uint32_t* cigar, int64_t n_cigar,
                          const int8_t* mat, int m, int q, int e,
                          int q2, int e2, int end_bonus,
                          uint32_t* cigar_out, long long* out8)
{
    // pass 1: prefix score S(step) over atomic path steps, tracking both
    // the Kadane best window and the full-path endpoints (for the
    // end_bonus comparison: the reference's extensions prefer reaching
    // the read end when score_at_end + end_bonus beats the interior max,
    // align.c:779-890 / ksw mqe+end_bonus logic)
    long long cur = 0, best = -1, cs_q = 0, cs_t = 0, cs_S = 0, S = 0;
    long long bq0 = 0, bt0 = 0, bq1 = 0, bt1 = 0, bS0 = 0;
    long long iq = 0, it = 0;
    for (int64_t k = 0; k < n_cigar; ++k) {
        uint32_t op = cigar[k] & 0xf, len = cigar[k] >> 4;
        if (op == 0) {                          // M: per-base
            for (uint32_t l = 0; l < len; ++l) {
                int d = mat[tseq[it] * m + qseq[iq]];
                if (cur <= 0 && d > 0) { cur = 0; cs_q = iq; cs_t = it;
                                         cs_S = S; }
                cur += d; S += d;
                ++iq; ++it;
                if (cur > best) {
                    best = cur; bq0 = cs_q; bt0 = cs_t; bq1 = iq; bt1 = it;
                    bS0 = cs_S;
                }
                if (cur < 0) { cur = 0; cs_q = iq; cs_t = it; cs_S = S; }
            }
        } else {
            long long p1 = (long long)q + (long long)e * len;
            long long p2 = (long long)q2 + (long long)e2 * len;
            long long pen = p1 < p2 ? p1 : p2;
            cur -= pen; S -= pen;
            if (op == 1) iq += len;
            else it += len;                     // D or N consume target
            if (cur < 0) { cur = 0; cs_q = iq; cs_t = it; cs_S = S; }
        }
    }
    if (best > 0 && end_bonus > 0) {
        // extend the window to the path END when the end-bonused score
        // there beats the interior max (right extension reach-end)
        if (bq1 < iq && S - bS0 + end_bonus >= best) {
            best = S - bS0; bq1 = iq; bt1 = it;
        }
        // and to the path START (left extension reach-end); recompute
        // the window score from prefix 0
        if (bq0 > 0) {
            // S at bq1 = bS0 + best
            long long s_from0 = bS0 + best;   // window [0, bq1) score
            if (s_from0 + end_bonus >= best) {
                best = s_from0; bq0 = 0; bt0 = 0;
            }
        }
    }
    out8[4] = best;
    if (best <= 0) { out8[0] = out8[1] = out8[2] = out8[3] = 0;
                     out8[5] = 0; return; }
    out8[0] = bq0; out8[1] = bt0; out8[2] = bq1; out8[3] = bt1;
    // pass 2: emit the cigar restricted to [bq0,bq1) x [bt0,bt1)
    int64_t no = 0;
    iq = 0; it = 0;
    for (int64_t k = 0; k < n_cigar; ++k) {
        uint32_t op = cigar[k] & 0xf, len = cigar[k] >> 4;
        long long q_lo = iq, t_lo = it;
        long long q_hi = iq + (op != 2 && op != 3 ? len : 0);
        long long t_hi = it + (op != 1 ? len : 0);
        iq = q_hi; it = t_hi;
        // inside the window?
        long long keep = 0;
        if (op == 0) {
            long long lo = q_lo < bq0 ? bq0 : q_lo;
            long long hi = q_hi > bq1 ? bq1 : q_hi;
            keep = hi - lo;
        } else if (op == 1) {
            if (q_lo >= bq0 && q_hi <= bq1 && t_lo >= bt0 && t_lo < bt1)
                keep = len;
        } else {
            if (t_lo >= bt0 && t_hi <= bt1 && q_lo >= bq0 && q_lo < bq1)
                keep = len;
        }
        if (keep <= 0) continue;
        if (no > 0 && (cigar_out[no - 1] & 0xf) == op)
            cigar_out[no - 1] += (uint32_t)keep << 4;
        else
            cigar_out[no++] = (uint32_t)keep << 4 | op;
    }
    out8[5] = no;
}

// ---------------------------------------------------------------------
// FASTA/FASTQ buffer parser (bseq.c + kseq.h as a C++ host extension):
// scans a decompressed text buffer and emits, per record,
//   meta[6*i+0] name offset   (into buf)
//   meta[6*i+1] name length   (to the first blank)
//   meta[6*i+2] comment offset (0-length if none)
//   meta[6*i+3] comment length
//   meta[6*i+4] seq offset    (into out_seq, newline-stripped copy)
//   meta[6*i+5] seq length
// plus qual offsets (into out_seq) in qmeta[2*i] / qmeta[2*i+1]
// (length 0 = FASTA).  U/u -> T/t happens here (bseq.c:72-74).
// Returns #records; -1 if caps were exceeded; *consumed = bytes of buf
// fully parsed (callers stream chunks and carry the remainder).
// ---------------------------------------------------------------------
int64_t mm_fastx_scan(const uint8_t* buf, int64_t n, int is_final,
                      uint8_t* out_seq, int64_t seq_cap,
                      int64_t* meta, int64_t* qmeta, int64_t rec_cap,
                      int64_t* consumed)
{
    int64_t i = 0, nrec = 0, so = 0;
    *consumed = 0;
    while (i < n) {
        // skip blank lines
        while (i < n && (buf[i] == '\n' || buf[i] == '\r')) ++i;
        if (i >= n) break;
        if (buf[i] != '>' && buf[i] != '@') return -2;  // malformed
        int is_fq = buf[i] == '@';
        int64_t rec_start = i;
        ++i;
        int64_t name_off = i;
        while (i < n && buf[i] != '\n' && buf[i] != '\r'
               && buf[i] != ' ' && buf[i] != '\t') ++i;
        int64_t name_len = i - name_off;
        int64_t com_off = 0, com_len = 0;
        while (i < n && (buf[i] == ' ' || buf[i] == '\t')) ++i;
        if (i < n && buf[i] != '\n' && buf[i] != '\r') {
            com_off = i;
            while (i < n && buf[i] != '\n' && buf[i] != '\r') ++i;
            com_len = i - com_off;
        } else {
            while (i < n && buf[i] != '\n') ++i;
        }
        if (i >= n && !is_final) { i = rec_start; break; }
        while (i < n && (buf[i] == '\n' || buf[i] == '\r')) ++i;
        int64_t seq_off = so;
        if (!is_fq) {
            // FASTA: sequence lines until the next record or EOF
            // (kseq treats both '>' and '@' as record starts)
            int64_t j = i;
            while (j < n && buf[j] != '>' && buf[j] != '@') {
                while (j < n && buf[j] != '\n') {
                    uint8_t c = buf[j];
                    if (c != '\r') {
                        if (c == 'U') c = 'T';
                        else if (c == 'u') c = 't';
                        if (so >= seq_cap) return -1;
                        out_seq[so++] = c;
                    }
                    ++j;
                }
                while (j < n && (buf[j] == '\n' || buf[j] == '\r')) ++j;
            }
            if (j >= n && !is_final) { so = seq_off; i = rec_start; break; }
            i = j;
            if (nrec >= rec_cap) return -1;
            meta[6 * nrec + 0] = name_off;
            meta[6 * nrec + 1] = name_len;
            meta[6 * nrec + 2] = com_off;
            meta[6 * nrec + 3] = com_len;
            meta[6 * nrec + 4] = seq_off;
            meta[6 * nrec + 5] = so - seq_off;
            qmeta[2 * nrec] = 0;
            qmeta[2 * nrec + 1] = 0;
            ++nrec;
            *consumed = i;
        } else {
            // FASTQ: one seq line, '+' line, one qual line of equal length
            int64_t j = i;
            while (j < n && buf[j] != '\n') {
                uint8_t c = buf[j];
                if (c != '\r') {
                    if (c == 'U') c = 'T';
                    else if (c == 'u') c = 't';
                    if (so >= seq_cap) return -1;
                    out_seq[so++] = c;
                }
                ++j;
            }
            int64_t slen = so - seq_off;
            if (j >= n && !is_final) { so = seq_off; i = rec_start; break; }
            ++j;                                    // past '\n'
            if (j >= n || buf[j] != '+') {
                if (!is_final) { so = seq_off; i = rec_start; break; }
                return -2;
            }
            while (j < n && buf[j] != '\n') ++j;
            ++j;
            int64_t qual_off = so;
            int64_t got = 0;
            while (j < n && got < slen) {
                uint8_t c = buf[j];
                if (c != '\n' && c != '\r') {
                    if (so >= seq_cap) return -1;
                    out_seq[so++] = c;
                    ++got;
                }
                ++j;
            }
            if (got < slen && !is_final) { so = seq_off; i = rec_start;
                                           break; }
            while (j < n && (buf[j] == '\n' || buf[j] == '\r')) ++j;
            i = j;
            if (nrec >= rec_cap) return -1;
            meta[6 * nrec + 0] = name_off;
            meta[6 * nrec + 1] = name_len;
            meta[6 * nrec + 2] = com_off;
            meta[6 * nrec + 3] = com_len;
            meta[6 * nrec + 4] = seq_off;
            meta[6 * nrec + 5] = slen;
            qmeta[2 * nrec] = qual_off;
            qmeta[2 * nrec + 1] = got;
            ++nrec;
            *consumed = i;
        }
    }
    return nrec;
}

}  // extern "C"
