// Threaded LSD radix sort of uint64 keys — the native twin of the
// reference's lex_sort (map.c:153-444): 8 bits per pass over the active
// bytes only, per-thread bucket counting with cross-thread scatter offsets
// so the output is globally sorted and stable.  Used for the k-mer index
// and seed-hit sorts (keys are packed (code|rank) / (aread,bread,apos)
// words, so one u64 sort covers the reference's multi-byte Lex_Arg plans).
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread (see native/__init__.py)

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Part {
    const uint64_t *src;
    uint64_t *dst;
    int64_t beg, end;
    int shift;
    int64_t count[256];
    int64_t offset[256];
};

void count_pass(Part *p) {
    memset(p->count, 0, sizeof(p->count));
    const uint64_t *s = p->src;
    int sh = p->shift;
    for (int64_t i = p->beg; i < p->end; i++)
        p->count[(s[i] >> sh) & 0xFF]++;
}

void scatter_pass(Part *p) {
    const uint64_t *s = p->src;
    uint64_t *d = p->dst;
    int sh = p->shift;
    int64_t off[256];
    memcpy(off, p->offset, sizeof(off));
    for (int64_t i = p->beg; i < p->end; i++) {
        uint64_t v = s[i];
        d[off[(v >> sh) & 0xFF]++] = v;
    }
}

}  // namespace

extern "C" {

// Sorts data[0..n-1] ascending (stable); tmp must hold n entries.
// active_mask: bytes of the key that can differ (pass skipped when the
// mask byte is zero).  Returns 0 if the result is in `data`, 1 if in `tmp`
// (the caller copies back when 1 — kept simple for the ctypes boundary).
int radix_sort_u64(uint64_t *data, uint64_t *tmp, int64_t n, int nthreads,
                   uint64_t active_mask) {
    if (n <= 1) return 0;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;

    uint64_t *src = data, *dst = tmp;
    std::vector<Part> parts(nthreads);
    std::vector<std::thread> th;
    th.reserve(nthreads);

    for (int pass = 0; pass < 8; pass++) {
        if (((active_mask >> (8 * pass)) & 0xFF) == 0) continue;
        int shift = 8 * pass;

        for (int t = 0; t < nthreads; t++) {
            Part &p = parts[t];
            p.src = src;
            p.dst = dst;
            p.beg = n * t / nthreads;
            p.end = n * (t + 1) / nthreads;
            p.shift = shift;
        }
        for (int t = 0; t < nthreads; t++)
            th.emplace_back(count_pass, &parts[t]);
        for (auto &x : th) x.join();
        th.clear();

        // global stable offsets: bucket-major, thread-minor
        int64_t sum = 0;
        for (int b = 0; b < 256; b++)
            for (int t = 0; t < nthreads; t++) {
                parts[t].offset[b] = sum;
                sum += parts[t].count[b];
            }

        for (int t = 0; t < nthreads; t++)
            th.emplace_back(scatter_pass, &parts[t]);
        for (auto &x : th) x.join();
        th.clear();

        uint64_t *sw = src; src = dst; dst = sw;
    }
    return src == data ? 0 : 1;
}

}  // extern "C"
