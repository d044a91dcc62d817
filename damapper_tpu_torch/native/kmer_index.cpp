// Native k-mer index build — the tuple_thread + lex_sort stage of the
// reference (map.c:447-822) as one fused, threaded pass: rolling 2-bit
// codes over (optionally soft-masked) read windows, a stable threaded LSD
// radix sort keyed on the code, and the permutation of (read, rpos).
// numpy needs ~6 full-array passes with temporaries for the same work;
// this does ~2.5 passes total.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void radix_u64(uint64_t *data, uint64_t *tmp, int64_t n, int nthreads,
               uint64_t active_mask) {
    struct Part {
        int64_t beg, end;
        int64_t count[256];
        int64_t offset[256];
    };
    std::vector<Part> parts(nthreads);
    std::vector<std::thread> th;
    uint64_t *src = data, *dst = tmp;
    for (int pass = 0; pass < 8; pass++) {
        if (((active_mask >> (8 * pass)) & 0xFF) == 0) continue;
        int shift = 8 * pass;
        for (int t = 0; t < nthreads; t++) {
            parts[t].beg = n * t / nthreads;
            parts[t].end = n * (t + 1) / nthreads;
        }
        for (int t = 0; t < nthreads; t++)
            th.emplace_back([&, t] {
                Part &p = parts[t];
                memset(p.count, 0, sizeof(p.count));
                for (int64_t i = p.beg; i < p.end; i++)
                    p.count[(src[i] >> shift) & 0xFF]++;
            });
        for (auto &x : th) x.join();
        th.clear();
        int64_t sum = 0;
        for (int b = 0; b < 256; b++)
            for (int t = 0; t < nthreads; t++) {
                parts[t].offset[b] = sum;
                sum += parts[t].count[b];
            }
        for (int t = 0; t < nthreads; t++)
            th.emplace_back([&, t] {
                Part &p = parts[t];
                int64_t off[256];
                memcpy(off, p.offset, sizeof(off));
                // write-combining stage: random 8B scatters into GB-scale
                // destinations are TLB/cache-miss bound; collect 32 entries
                // per bucket and flush 256B sequential chunks instead
                constexpr int SB = 32;
                static thread_local uint64_t stage[256][SB];
                int scnt[256];
                memset(scnt, 0, sizeof(scnt));
                for (int64_t i = p.beg; i < p.end; i++) {
                    uint64_t v = src[i];
                    int b = (v >> shift) & 0xFF;
                    stage[b][scnt[b]] = v;
                    if (++scnt[b] == SB) {
                        memcpy(dst + off[b], stage[b], SB * 8);
                        off[b] += SB;
                        scnt[b] = 0;
                    }
                }
                for (int b = 0; b < 256; b++)
                    if (scnt[b]) {
                        memcpy(dst + off[b], stage[b], scnt[b] * 8);
                        off[b] += scnt[b];
                    }
            });
        for (auto &x : th) x.join();
        th.clear();
        uint64_t *sw = src; src = dst; dst = sw;
    }
    if (src != data) memcpy(data, src, sizeof(uint64_t) * n);
}

// MSD-partitioned pair sort: one DRAM pass scatters (key, payload) into
// 256 partitions by the top code byte; each partition (typically L2/L3
// resident) is then LSD-sorted over the remaining bits with 11-bit
// digits.  Total DRAM traffic ~2 passes instead of 5+ — this host is
// write-bandwidth bound (~2 GB/s), so passes are the whole cost.
// Stability matches a full LSD sort (stable at both levels).
void sort_pairs_msd(uint64_t *key, uint64_t *pay, uint64_t *tmpk,
                    uint64_t *tmpp, int64_t n, int codebits) {
    int msh = codebits > 8 ? codebits - 8 : 0;

    // --- MSD scatter into tmpk/tmpp (write-combined) ---
    int64_t cnt[256];
    memset(cnt, 0, sizeof(cnt));
    for (int64_t i = 0; i < n; i++) cnt[(key[i] >> msh) & 0xFF]++;
    int64_t off[256], beg[257];
    int64_t sum = 0;
    for (int b = 0; b < 256; b++) {
        beg[b] = off[b] = sum;
        sum += cnt[b];
    }
    beg[256] = sum;
    {
        constexpr int SB = 32;
        static thread_local uint64_t stk[256][SB], stp[256][SB];
        int scnt[256];
        memset(scnt, 0, sizeof(scnt));
        for (int64_t i = 0; i < n; i++) {
            uint64_t k2 = key[i];
            int b = (k2 >> msh) & 0xFF;
            stk[b][scnt[b]] = k2;
            stp[b][scnt[b]] = pay[i];
            if (++scnt[b] == SB) {
                memcpy(tmpk + off[b], stk[b], SB * 8);
                memcpy(tmpp + off[b], stp[b], SB * 8);
                off[b] += SB;
                scnt[b] = 0;
            }
        }
        for (int b = 0; b < 256; b++)
            if (scnt[b]) {
                memcpy(tmpk + off[b], stk[b], scnt[b] * 8);
                memcpy(tmpp + off[b], stp[b], scnt[b] * 8);
            }
    }

    if (msh == 0) {
        memcpy(key, tmpk, sizeof(uint64_t) * n);
        memcpy(pay, tmpp, sizeof(uint64_t) * n);
        return;
    }

    // --- per-partition LSD over the low msh bits, odd digit count so the
    // result lands back in key/pay ---
    int nd = (msh + 10) / 11;
    if ((nd & 1) == 0) nd++;
    int wd = (msh + nd - 1) / nd;     // digit width <= 11
    int64_t dcnt[1 << 11];
    for (int b = 0; b < 256; b++) {
        int64_t lo = beg[b], m = beg[b + 1] - beg[b];
        if (m <= 0) continue;
        uint64_t *ks = tmpk + lo, *kd = key + lo;
        uint64_t *ps = tmpp + lo, *pd = pay + lo;
        int sh = 0;
        for (int d = 0; d < nd; d++) {
            int w = (sh + wd > msh) ? (msh - sh) : wd;
            if (w <= 0) {  // exhausted bits: copy-through keeps parity
                memcpy(kd, ks, m * 8);
                memcpy(pd, ps, m * 8);
            } else {
                int nb = 1 << w;
                uint64_t dm = nb - 1;
                memset(dcnt, 0, nb * sizeof(int64_t));
                for (int64_t i = 0; i < m; i++)
                    dcnt[(ks[i] >> sh) & dm]++;
                int64_t s2 = 0;
                for (int bb = 0; bb < nb; bb++) {
                    int64_t c2 = dcnt[bb];
                    dcnt[bb] = s2;
                    s2 += c2;
                }
                for (int64_t i = 0; i < m; i++) {
                    int64_t j = dcnt[(ks[i] >> sh) & dm]++;
                    kd[j] = ks[i];
                    pd[j] = ps[i];
                }
            }
            sh += w;
            uint64_t *sw;
            sw = ks; ks = kd; kd = sw;
            sw = ps; ps = pd; pd = sw;
        }
    }
}

}  // namespace

extern "C" {

// Count the k-mers that phase 2 will emit (windows fully inside unmasked
// intervals), filling per-read output offsets into offs[nreads+1].
int64_t kmer_count(const int32_t *rlens, int32_t nreads, int kmer,
                   const int64_t *mask_anno, const int32_t *mask_data,
                   int64_t *offs) {
    int64_t total = 0;
    for (int32_t r = 0; r < nreads; r++) {
        offs[r] = total;
        int32_t rlen = rlens[r];
        if (mask_anno == nullptr) {
            if (rlen >= kmer) total += rlen - kmer + 1;
            continue;
        }
        int64_t mb = mask_anno[r], me = mask_anno[r + 1];
        int32_t p = 0;
        for (int64_t m = mb; m < me; m += 2) {
            int32_t q = mask_data[m];
            if (q - p >= kmer) total += q - p - kmer + 1;
            p = mask_data[m + 1];
        }
        if (rlen - p >= kmer) total += rlen - p - kmer + 1;
    }
    offs[nreads] = total;
    return total;
}

// Emit + sort the index.  seq: the loaded numeric base memory; boffs: per
// read offset into seq; codes/reads/rposs: output arrays of size total.
// idx_bits: when > 0, codes are packed with their emission rank and radix
// sorted (requires 2*kmer + idx_bits <= 64); when 0 the caller sorts.
// idx_bits == -1 selects the pair sort instead: (read,rpos) packed into a
// u64 payload carried through every radix pass — no bound on total, at
// ~2x the traffic (pay/tmpp must then be non-null; pr/pp unused).
// tmp (u64[total]) and pr/pp (i32[total]) are caller-provided scratch so
// repeated builds reuse warm pages instead of faulting ~200MB per call.
void kmer_index(const uint8_t *seq, const int64_t *boffs,
                const int32_t *rlens, int32_t nreads, int kmer,
                const int64_t *mask_anno, const int32_t *mask_data,
                const int64_t *offs, uint64_t *codes, int32_t *reads,
                int32_t *rposs, int idx_bits, int nthreads,
                uint64_t *tmp, int32_t *pr, int32_t *pp,
                uint64_t *pay, uint64_t *tmpp) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    std::vector<std::thread> th;

    // phase 1: rolling codes per read window (threaded over reads)
    uint64_t kmask = (kmer < 32) ? ((1ULL << (2 * kmer)) - 1) : ~0ULL;
    for (int t = 0; t < nthreads; t++)
        th.emplace_back([&, t] {
            for (int32_t r = t; r < nreads; r += nthreads) {
                int64_t o = offs[r];
                const uint8_t *s = seq + boffs[r];
                int32_t rlen = rlens[r];
                auto emit_win = [&](int32_t p, int32_t q) {
                    if (q - p < kmer) return;
                    uint64_t c = 0;
                    for (int32_t j = p; j < p + kmer - 1; j++)
                        c = (c << 2) | s[j];
                    for (int32_t j = p + kmer - 1; j < q; j++) {
                        c = ((c << 2) | s[j]) & kmask;
                        codes[o] = c;
                        reads[o] = r;
                        rposs[o] = j;
                        o++;
                    }
                };
                if (mask_anno == nullptr) {
                    emit_win(0, rlen);
                } else {
                    int64_t mb = mask_anno[r], me = mask_anno[r + 1];
                    int32_t p = 0;
                    for (int64_t m = mb; m < me; m += 2) {
                        emit_win(p, mask_data[m]);
                        p = mask_data[m + 1];
                    }
                    emit_win(p, rlen);
                }
            }
        });
    for (auto &x : th) x.join();
    th.clear();

    if (idx_bits == 0) return;
    int64_t n = offs[nreads];

    if (idx_bits < 0) {
        // pair path: payload = (read << 32) | rpos rides the radix passes
        for (int t = 0; t < nthreads; t++)
            th.emplace_back([&, t] {
                int64_t beg = n * t / nthreads, end = n * (t + 1) / nthreads;
                for (int64_t i = beg; i < end; i++)
                    pay[i] = ((uint64_t)(uint32_t)reads[i] << 32)
                             | (uint32_t)rposs[i];
            });
        for (auto &x : th) x.join();
        th.clear();
        sort_pairs_msd(codes, pay, tmp, tmpp, n,
                       (kmer >= 32) ? 64 : 2 * kmer);
        for (int t = 0; t < nthreads; t++)
            th.emplace_back([&, t] {
                int64_t beg = n * t / nthreads, end = n * (t + 1) / nthreads;
                for (int64_t i = beg; i < end; i++) {
                    reads[i] = (int32_t)(pay[i] >> 32);
                    rposs[i] = (int32_t)(pay[i] & 0xFFFFFFFFu);
                }
            });
        for (auto &x : th) x.join();
        th.clear();
        return;
    }

    // phase 2: pack rank into the low bits, radix sort, unpack + permute
    for (int t = 0; t < nthreads; t++)
        th.emplace_back([&, t] {
            int64_t beg = n * t / nthreads, end = n * (t + 1) / nthreads;
            for (int64_t i = beg; i < end; i++)
                codes[i] = (codes[i] << idx_bits) | (uint64_t)i;
        });
    for (auto &x : th) x.join();
    th.clear();

    int actbits = 2 * kmer + idx_bits;
    uint64_t act = (actbits >= 64) ? ~0ULL : ((1ULL << actbits) - 1);
    // whole bytes holding only the rank need no pass: LSD stability keeps
    // equal codes in emission (= rank) order, matching a full-key sort
    int skipb = idx_bits / 8;
    if (skipb > 0 && skipb < 8) act &= ~((1ULL << (8 * skipb)) - 1);
    radix_u64(codes, tmp, n, nthreads, act);

    // permute reads/rposs through tmp storage (threaded)
    uint64_t rmask = (1ULL << idx_bits) - 1;
    for (int t = 0; t < nthreads; t++)
        th.emplace_back([&, t] {
            int64_t beg = n * t / nthreads, end = n * (t + 1) / nthreads;
            for (int64_t i = beg; i < end; i++) {
                int64_t src_i = (int64_t)(codes[i] & rmask);
                pr[i] = reads[src_i];
                pp[i] = rposs[src_i];
                codes[i] >>= idx_bits;
            }
        });
    for (auto &x : th) x.join();
    th.clear();
    memcpy(reads, pr, sizeof(int32_t) * n);
    memcpy(rposs, pp, sizeof(int32_t) * n);
}

// Locate each sorted (unique) query code's range in a sorted key array:
// lo[i]..hi[i] spans keys == q[i].  One linear merge scan — sequential
// reads replace per-query binary searches (27 cache misses each at 140M
// keys).  Equivalent to np.searchsorted(keys, q, "left"/"right").
void merge_ranges(const uint64_t *q, int64_t nq, const uint64_t *keys,
                  int64_t nk, int64_t *lo, int64_t *hi) {
    int64_t j = 0;
    for (int64_t i = 0; i < nq; i++) {
        uint64_t c = q[i];
        while (j < nk && keys[j] < c) j++;
        lo[i] = j;
        while (j < nk && keys[j] == c) j++;
        hi[i] = j;
    }
}

}  // extern "C"
