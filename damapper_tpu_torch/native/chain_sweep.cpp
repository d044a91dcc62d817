// Native chain sweep: the per-(read, contig, orientation) k-mer chain DP.
//
// Semantics-parity redesign of the reference's splay-tree sweep
// (chain_thread, reference map.c:1020-1922) as an ordered-map sweep: the
// queries the splay tree answers are order statistics on the *set* of active
// hits, independent of tree shape (see ops/chain.py for the
// derivation), so a std::map keyed on (diag, apos) with short directional
// walks yields identical chains.
//
// For each hit (ascending apos, ties ascending bpos):
//   * expire active hits with apos < cur - MAX_GAP (chain-best expiries are
//     remembered for the end-of-group scan),
//   * pred   = smallest key > (diag,apos) with bpos >= bpos-MAX_GAP,
//     then the largest-apos active node on pred's diagonal,
//   * succ   = largest key < (diag,apos) with bpos <= bpos,
//   * extend the higher-cost predecessor (cost += min(kmer, advance), ties
//     prefer succ), track per-chain best via the origin's best pointer, and
//     absorb the predecessor when |ddiag| <= .2*dapos.
// At group end, scan active nodes in decreasing key order then expiries in
// order; chains with cost >= 3*kmer whose node is its chain's best are
// emitted as candidates with their compressed jump lists (chain_length
// semantics: same-diagonal steps < 100bp apart are spliced out).
//
// Emission order matches the reference scan order exactly so the Python
// layer can apply the MIN_PIECE/0.9 dominance rule incrementally.

#include <cstdint>
#include <cstdlib>
#include <map>
#include <vector>

namespace {

constexpr int MAX_GAP = 1000;   // map.c:36
constexpr int HITMIN = 3;       // map.c:34

struct Node {
    int32_t apos, bpos, diag;
    int32_t cost;
    Node *frm, *orig, *best;
    bool absorbed;
};

struct Result {
    // candidate stream: [ar, br, cost, ab, ae, bb, be, njumps] per candidate
    std::vector<int32_t> meta;
    std::vector<int32_t> jumps;  // (adisp, bdisp) pairs, flattened
};

using Key = std::pair<int32_t, int32_t>;  // (diag, apos)

static int chain_length(Node *h) {
    int n = 0;
    Node *x = h;
    Node *y = x->frm;
    while (y) {
        int da = x->apos - y->apos;
        if (da == x->bpos - y->bpos && da < 100) {
            y = x->frm = y->frm;
        } else {
            n += 1;
            x = y;
            y = x->frm;
        }
    }
    return n;
}

static void sweep_group(int32_t ar, int32_t br,
                        const int32_t *apos, const int32_t *bpos,
                        int64_t count, int kmer, Result &res,
                        std::vector<Node> &nodes) {
    const int hithr = HITMIN * kmer;
    nodes.clear();
    nodes.reserve(count);

    std::map<Key, Node *> active;
    std::vector<Node *> queue;
    size_t qhead = 0;
    std::vector<Node *> expired;

    for (int64_t i = 0; i < count; i++) {
        int32_t ap = apos[i];
        int32_t bp = bpos[i];

        while (qhead < queue.size() && queue[qhead]->apos < ap - MAX_GAP) {
            Node *nd = queue[qhead++];
            if (!nd->absorbed) {
                active.erase(Key(nd->diag, nd->apos));
                if (nd->orig->best == nd) expired.push_back(nd);
            }
        }

        nodes.push_back(Node{ap, bp, ap - bp, 0, nullptr, nullptr, nullptr,
                             false});
        Node *nd = &nodes.back();
        nd->orig = nd;
        nd->best = nd;
        Key key(nd->diag, nd->apos);
        auto it = active.emplace(key, nd).first;

        int32_t thresh = bp - MAX_GAP;
        Node *l = nullptr;
        {
            auto j = std::next(it);
            for (; j != active.end(); ++j)
                if (j->second->bpos >= thresh) { l = j->second; break; }
        }
        if (l) {
            // largest-apos active node on l's diagonal (always qualifies)
            auto j = active.upper_bound(Key(l->diag, INT32_MAX));
            --j;
            if (j->second->diag == l->diag) l = j->second;
        }
        Node *r = nullptr;
        {
            auto j = it;
            while (j != active.begin()) {
                --j;
                if (j->second->bpos <= bp) { r = j->second; break; }
            }
        }

        int32_t lcost = 0, rcost = 0;
        if (l) lcost = l->cost + (ap >= l->apos + kmer ? kmer : ap - l->apos);
        if (r) rcost = r->cost + (bp >= r->bpos + kmer ? kmer : bp - r->bpos);
        if (lcost > rcost) rcost = 0; else lcost = 0;

        Node *p = nullptr;
        int32_t cost = 0;
        if (lcost > 0) { p = l; cost = lcost; }
        else if (rcost > 0) { p = r; cost = rcost; }

        if (p) {
            nd->frm = p;
            nd->cost = cost;
            nd->orig = (p->frm == nullptr) ? p : p->orig;
            if (cost >= nd->orig->best->cost) {
                nd->orig->best = nd;
                int dd = p->diag - nd->diag;
                if (dd < 0) dd = -dd;
                if (dd <= .2 * (nd->apos - p->apos)) {
                    active.erase(Key(p->diag, p->apos));
                    p->absorbed = true;
                }
            }
        } else {
            nd->frm = nullptr;
            nd->cost = kmer;
            nd->orig = nd;
        }
        queue.push_back(nd);
    }

    // end-of-group scan: active set in decreasing key order, then expiries
    // in REVERSE expiry order (the reference prepends each expiring node,
    // map.c:1790-1794, so its expired list is LIFO; the order decides which
    // of two equal-span LAs survives Handle_Redundancies)
    auto emit = [&](Node *h) {
        if (h->cost >= hithr && h->orig->best == h) {
            int32_t ab = h->orig->apos - kmer;
            int32_t bb = h->orig->bpos - kmer;
            int len = chain_length(h);
            res.meta.push_back(ar);
            res.meta.push_back(br);
            res.meta.push_back(h->cost);
            res.meta.push_back(ab);
            res.meta.push_back(h->apos);
            res.meta.push_back(bb);
            res.meta.push_back(h->bpos);
            res.meta.push_back(len);
            Node *g = h;
            for (Node *f = h->frm; f; f = f->frm) {
                res.jumps.push_back(g->apos - f->apos);
                res.jumps.push_back(g->bpos - f->bpos);
                g = f;
            }
        }
    };
    for (auto j = active.rbegin(); j != active.rend(); ++j) emit(j->second);
    for (auto j = expired.rbegin(); j != expired.rend(); ++j) emit(*j);
}

}  // namespace

extern "C" {

void *chain_sweep(int64_t n, const int32_t *aread, const int32_t *bread,
                  const int32_t *apos, const int32_t *bpos, int kmer) {
    auto *res = new Result();
    std::vector<Node> nodes;
    int64_t s = 0;
    while (s < n) {
        int64_t e = s + 1;
        while (e < n && aread[e] == aread[s] && bread[e] == bread[s]) e++;
        sweep_group(aread[s], bread[s], apos + s, bpos + s, e - s, kmer,
                    *res, nodes);
        s = e;
    }
    return res;
}

int64_t result_meta_len(void *h) {
    return (int64_t) ((Result *) h)->meta.size();
}
const int32_t *result_meta(void *h) { return ((Result *) h)->meta.data(); }
int64_t result_jumps_len(void *h) {
    return (int64_t) ((Result *) h)->jumps.size();
}
const int32_t *result_jumps(void *h) { return ((Result *) h)->jumps.data(); }
void result_free(void *h) { delete (Result *) h; }

}  // extern "C"
