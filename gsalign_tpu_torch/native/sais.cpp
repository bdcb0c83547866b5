// SA-IS suffix array construction (induced sorting), C++17.
//
// The index build's suffix sort: the reference uses an incremental BWT-SW
// builder (reference src/BWT_Index/bwt_gen.c) designed to bound 2008-era
// RAM; here the full suffix array is built in O(n) by SA-IS and the
// BWT/occ/SA samples derive from it. Independent implementation of the
// standard SA-IS algorithm (Nong, Zhang & Chan 2009), templated over the
// index type I so that texts of 2^31 rows and more use 64-bit indices.
//
// Memory: the build holds the suffix array, the caller's text and one
// byte of types a text row, and well under half a byte a row besides
// (a 6.2 G-row text: 8 + 1 + 1 bytes a row with an int64 SA).
//  - Top level: symbol and type are FUSED into one byte, tt[i] =
//    t[i]*2 + stype[i] (stype 1 = S, 0 = L), so the induction loops issue
//    ONE random read per element. The entry points build tt straight from
//    the caller's codes, whose +1 and sentinel are implied (no copy of the
//    text is made).
//  - Recursion: the reduced string lies in the tail of sa, as in classic
//    SA-IS, and is fused with its types IN PLACE (s[i] = name*2 + stype),
//    so a level allocates no text or type array of its own.
//  - Buckets are per symbol (k entries: L-type suffixes fill a bucket from
//    its head, S-type from its tail). A level with a large alphabet keeps
//    them in the free middle of sa, between the level's SA (sa[0, n)) and
//    its text (the parent's tail); where only one k-array fits there, the
//    bucket bounds are recounted from the text each time they are needed.
//  - The LMS compactions and the step-4 mapping run in place in sa: a
//    stable compaction is done per thread block, then the blocks are
//    moved together.
//
// Threads: the induction scans stay sequential (their bucket-front writes
// are loop-carried), as does the step-5 placement (in place, each write
// lands at or past the entry it came from); every other phase (types,
// histograms, LMS placement, compactions, naming, the mapping) is a linear
// pass that runs per block on threads.
//
// Convention: the text ENDS with a unique smallest symbol (sentinel),
// t[n-1] == 0 and t[i] > 0 for i < n-1.
//
// Exported C ABI (0 on success, < 0 on malformed codes):
//   int sais_codes_i32_mt(const uint8_t* codes, int32_t m, int32_t* sa, int)
//   int sais_codes_i64_mt(const uint8_t* codes, int64_t m, int64_t* sa, int)
//       the text codes[i] + 1 for i < m, then the sentinel: sa has m + 1
//       entries, codes < 127
//   int64_t sais_marks(int64_t* out, int64_t cap), void sais_marks_clear()
//       the memory milestones of the builds so far (see mark below)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <sys/resource.h>

namespace {

// ---- memory milestones ----------------------------------------------------
// Every level records (phase, depth, n, VmHWM bytes, VmRSS bytes) at each
// step; sais_marks hands them to the caller. GSALIGN_SAIS_DEBUG=1 also
// prints them to stderr.
enum Phase { ENTER, LMS_PLACED, INDUCE1, NAMED, MAPPED, FINAL_PLACE, DONE };
const char* const kPhaseName[] = {"enter", "lms-placed", "induce1", "named",
                                  "mapped", "final-place", "done"};

struct Mark {
    int64_t phase, depth, n, hwm, rss;
};
std::mutex g_mark_mu;
std::vector<Mark> g_marks;

// peak and current resident set of this process in bytes (/proc; the peak
// falls back to getrusage where /proc is unreadable)
void read_rss(int64_t& hwm, int64_t& rss) {
    hwm = rss = 0;
    if (FILE* f = std::fopen("/proc/self/status", "r")) {
        char line[256];
        long long v;
        while (std::fgets(line, sizeof line, f)) {
            if (std::sscanf(line, "VmHWM: %lld kB", &v) == 1) hwm = v * 1024;
            else if (std::sscanf(line, "VmRSS: %lld kB", &v) == 1)
                rss = v * 1024;
        }
        std::fclose(f);
    }
    if (hwm == 0) {
        struct rusage ru;
        getrusage(RUSAGE_SELF, &ru);
        hwm = int64_t(ru.ru_maxrss) * 1024;
    }
}

void mark(Phase p, int64_t n, int depth) {
    int64_t hwm, rss;
    read_rss(hwm, rss);
    {
        std::lock_guard<std::mutex> g(g_mark_mu);
        g_marks.push_back({int64_t(p), int64_t(depth), n, hwm, rss});
    }
    static const bool dbg = std::getenv("GSALIGN_SAIS_DEBUG") != nullptr;
    if (dbg)
        std::fprintf(stderr, "[sais d%d n=%lld] %-12s peakRSS=%.1f GB "
                     "RSS=%.1f GB\n", depth, (long long)n, kPhaseName[p],
                     hwm / 1e9, rss / 1e9);
}

// ---- threads ----------------------------------------------------------------
// f(s, e, t) over nt blocks of [0, n); one block below 2^16 elements. The
// partition depends on (n, nt) only, so two calls see the same blocks.
template <typename F>
void par_ranges(int64_t n, int nt, F f) {
    if (nt <= 1 || n < (1 << 16)) {
        f(int64_t(0), n, 0);
        return;
    }
    std::vector<std::thread> ts;
    ts.reserve(nt);
    int64_t chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t s = t * chunk;
        int64_t e = std::min<int64_t>(n, s + chunk);
        if (s >= e) break;
        ts.emplace_back([=]() { f(s, e, t); });
    }
    for (auto& th : ts) th.join();
}

// a[s, e) = -1 (all-0xFF bytes in two's complement)
template <typename I>
void par_fill_neg1(I* a, int64_t s, int64_t e, int nt) {
    par_ranges(e - s, nt, [&](int64_t x, int64_t y, int) {
        std::memset(a + s + x, 0xFF, size_t(y - x) * sizeof(I));
    });
}

// Stable in-place compaction of the a[i] with keep(a[i]) to the front of
// a[0, n); returns their count. Each block compacts within itself, then
// the blocks move down in order (each destination ends at or before its
// source's start, so no move overwrites data not yet moved).
template <typename I, typename P>
int64_t compact_front(I* a, int64_t n, int nt, P keep) {
    std::vector<int64_t> beg(nt, 0), cnt(nt, 0);
    par_ranges(n, nt, [&](int64_t s, int64_t e, int th) {
        int64_t w = s;
        for (int64_t i = s; i < e; i++)
            if (keep(a[i])) a[w++] = a[i];
        beg[th] = s;
        cnt[th] = w - s;
    });
    int64_t m = 0;
    for (int th = 0; th < nt; th++) {
        if (cnt[th] && beg[th] != m)
            std::memmove(a + m, a + beg[th], size_t(cnt[th]) * sizeof(I));
        m += cnt[th];
    }
    return m;
}

// Stable in-place compaction of the a[i] != -1 to the END of a[0, n);
// returns their count (the mirror image of compact_front).
template <typename I>
int64_t compact_back(I* a, int64_t n, int nt) {
    std::vector<int64_t> end(nt, 0), cnt(nt, 0);
    par_ranges(n, nt, [&](int64_t s, int64_t e, int th) {
        int64_t w = e;
        for (int64_t i = e - 1; i >= s; i--)
            if (a[i] != I(-1)) a[--w] = a[i];
        end[th] = e;
        cnt[th] = e - w;
    });
    int64_t m = 0;
    for (int th = nt - 1; th >= 0; th--) {
        if (cnt[th] && end[th] != n - m)
            std::memmove(a + n - m - cnt[th], a + end[th] - cnt[th],
                         size_t(cnt[th]) * sizeof(I));
        m += cnt[th];
    }
    return m;
}

// tt[i] = t(i)*2 + stype(i) for i in [0, n), where t(n-1) is the unique
// smallest symbol; tt may be the very array t reads (in place). First
// each block's seed (the type and the symbol just past its end, from a
// forward scan of the equal-symbol run, which cannot cross the sentinel)
// is read while nothing is written; then the blocks fill right to left,
// each reading only its own, not yet rewritten, entries.
template <typename I, typename TT, typename Src>
void fuse_types(const Src& t, TT* tt, I n, int nt) {
    std::vector<TT> seed_type(nt, 1);
    std::vector<int64_t> seed_sym(nt, 0);
    auto type_at = [&](I p) -> TT {
        if (p == n - 1) return 1;
        I q = p;
        while (t(q) == t(q + 1)) q++;
        return (TT)(t(q) < t(q + 1) ? 1 : 0);
    };
    par_ranges(int64_t(n) - 1, nt, [&](int64_t, int64_t e, int th) {
        seed_type[th] = type_at((I)e);
        seed_sym[th] = (int64_t)t((I)e);
    });
    int64_t last = (int64_t)t(n - 1);
    par_ranges(int64_t(n) - 1, nt, [&](int64_t s, int64_t e, int th) {
        TT cur = seed_type[th];
        int64_t nxt = seed_sym[th];
        for (int64_t i = e - 1; i >= s; i--) {
            int64_t a = (int64_t)t((I)i);
            TT st = a < nxt ? 1 : (a > nxt ? 0 : cur);
            tt[i] = (TT)(a * 2 + st);
            cur = st;
            nxt = a;
        }
    });
    tt[n - 1] = (TT)(last * 2 + 1);
}

// Bucket bounds of one level: symbol c's suffixes occupy [C[c], C[c+1]);
// B holds the moving fronts. C and B lie in the level's free space when
// both fit, in an allocation when they are small, else B alone in the free
// space (C == nullptr: heads and tails are recounted from the text) or,
// where not even that fits, alone in an allocation.
template <typename I, typename TT>
struct Buckets {
    const TT* tt;
    int64_t n, k;
    int nt;
    bool par;            // per-thread (nt x k) count arrays fit the budget
    I* C = nullptr;
    I* B = nullptr;
    std::vector<I> own;

    Buckets(const TT* tt_, int64_t n_, int64_t k_, int nt_, I* free,
            int64_t fs, int64_t spare)
        : tt(tt_), n(n_), k(k_), nt(nt_) {
        par = nt > 1 && int64_t(nt) * k * int64_t(sizeof(I)) * 2 <= spare;
        int64_t both = 2 * k + 1;
        if (both <= fs) {
            C = free;
            B = free + k + 1;
        } else if (both * int64_t(sizeof(I)) <= spare || both <= 4096) {
            own.resize(size_t(both));
            C = own.data();
            B = C + k + 1;
        } else if (k <= fs) {
            B = free;
        } else {
            own.resize(size_t(k));
            B = own.data();
        }
        if (C) {
            count(B);
            C[0] = 0;
            for (int64_t c = 0; c < k; c++) C[c + 1] = C[c] + B[c];
        }
    }

    // out[c] = #{i : tt[i] >> 1 == c}
    void count(I* out) const {
        if (!par) {
            std::fill(out, out + k, I(0));
            for (int64_t i = 0; i < n; i++) out[tt[i] >> 1]++;
            return;
        }
        std::vector<std::vector<I>> h(nt);
        par_ranges(n, nt, [&](int64_t s, int64_t e, int th) {
            auto& hh = h[th];
            hh.assign(size_t(k), I(0));
            for (int64_t i = s; i < e; i++) hh[tt[i] >> 1]++;
        });
        std::fill(out, out + k, I(0));
        for (auto& hh : h)
            if (!hh.empty())
                for (int64_t c = 0; c < k; c++) out[c] += hh[c];
    }

    void heads() {
        if (C) {
            std::memcpy(B, C, size_t(k) * sizeof(I));
            return;
        }
        count(B);
        I sum = 0;
        for (int64_t c = 0; c < k; c++) {
            I v = B[c];
            B[c] = sum;
            sum += v;
        }
    }

    void tails() {
        if (C) {
            std::memcpy(B, C + 1, size_t(k) * sizeof(I));
            return;
        }
        count(B);
        for (int64_t c = 1; c < k; c++) B[c] += B[c - 1];
    }
};

template <typename I, typename TT, typename BK>
void induce(const TT* tt, I* sa, BK& bk, I n) {
    // induce L-type from sorted LMS/S: ascending scan, append at the
    // bucket heads. The tt[j-1] read is a dependent random access and the
    // loop's latency bound; prefetching it a few iterations ahead (a stale
    // sa[] read is harmless: any value is -1 or a valid index) is worth
    // ~2x. Two-stage software pipeline: stage 1 (i+48) prefetches the
    // random tt read; stage 2 (i+16) re-reads it (L2-resident by now) to
    // learn the bucket and prefetches the WRITE line sa[bkt[c]], the other
    // half of the latency bound.
    bk.heads();
    I* bkt = bk.B;
    for (I i = 0; i < n; i++) {
        if (i + 48 < n) {
            I jp = sa[i + 48];
            if (jp > 0) __builtin_prefetch(tt + jp - 1);
        }
        if (i + 16 < n) {
            I jm = sa[i + 16];
            if (jm > 0) {
                TT vm = tt[jm - 1];
                if (!(vm & 1)) __builtin_prefetch(sa + bkt[vm >> 1], 1);
            }
        }
        I j = sa[i];
        if (j > 0) {
            TT v = tt[j - 1];
            if (!(v & 1)) sa[bkt[v >> 1]++] = j - 1;
        }
    }
    // induce S-type from L: descending scan, prepend at the bucket tails
    bk.tails();
    for (I i = n - 1; i >= 0; i--) {
        if (i >= 48) {
            I jp = sa[i - 48];
            if (jp > 0) __builtin_prefetch(tt + jp - 1);
        }
        if (i >= 16) {
            I jm = sa[i - 16];
            if (jm > 0) {
                TT vm = tt[jm - 1];
                if (vm & 1) __builtin_prefetch(sa + bkt[vm >> 1] - 1, 1);
            }
        }
        I j = sa[i];
        if (j > 0) {
            TT v = tt[j - 1];
            if (v & 1) sa[--bkt[v >> 1]] = j - 1;
        }
        if (i == 0) break;
    }
}

struct Ctx {
    int nt;              // threads
    int64_t spare;       // bytes a level may allocate besides sa and tt
};

// Sorts the suffixes of the fused text tt[0, n) (symbols < k, tt[n-1] == 1
// the sentinel) into sa[0, n). sa[n, n + fs) is free for this level.
template <typename I, typename TT>
void sais_core(TT* tt, I* sa, I n, I k, int64_t fs, const Ctx& cx,
               int depth) {
    if (n == 1) {
        sa[0] = 0;
        return;
    }
    int nt = n < (1 << 20) ? 1 : cx.nt;   // recursion tail: threads don't pay
    mark(ENTER, n, depth);
    auto is_lms = [&](I i) {
        return i > 0 && (tt[i] & 1) && !(tt[i - 1] & 1);
    };
    Buckets<I, TT> bk(tt, n, k, nt, sa + n, fs, cx.spare);

    // step 1: LMS suffixes at their bucket tails (text order), induce a
    // first sort. Parallel: per-block per-symbol counts fix each block's
    // descending write window up front.
    par_fill_neg1<I>(sa, 0, n, nt);
    bk.tails();
    if (!bk.par) {
        for (I i = n - 1; i >= 1; i--)
            if (is_lms(i)) sa[--bk.B[tt[i] >> 1]] = i;
    } else {
        std::vector<std::vector<I>> cnt(nt, std::vector<I>(size_t(k), 0));
        par_ranges(int64_t(n) - 1, nt, [&](int64_t s, int64_t e, int th) {
            auto& c = cnt[th];
            for (int64_t i = 1 + s; i < 1 + e; i++)
                if (is_lms((I)i)) c[tt[i] >> 1]++;
        });
        // block b's symbol-c window ends at the tail minus all LATER
        // blocks' counts (the sequential loop scans the text descending)
        for (I c = 0; c < k; c++) {
            I end = bk.B[c];
            for (int b = nt - 1; b >= 0; b--) {
                I m = cnt[b][c];
                cnt[b][c] = end;
                end -= m;
            }
        }
        par_ranges(int64_t(n) - 1, nt, [&](int64_t s, int64_t e, int th) {
            auto& o = cnt[th];
            for (int64_t i = e; i >= 1 + s; i--)
                if (is_lms((I)i)) sa[--o[tt[i] >> 1]] = (I)i;
        });
    }
    mark(LMS_PLACED, n, depth);
    induce<I, TT>(tt, sa, bk, n);
    mark(INDUCE1, n, depth);

    // step 2: the LMS in sorted order to sa[0, n1), their substrings
    // named. Naming parallelizes: diff[i] compares sa[i] with sa[i-1]
    // independently; names are the prefix sum of diff. A name goes to
    // sa[n1 + pos/2] (LMS positions are at least 2 apart).
    I n1 = (I)compact_front(sa, n, nt, [&](I p) { return is_lms(p); });
    par_fill_neg1<I>(sa, n1, n, nt);
    auto differs = [&](I pos, I prev) {
        for (I d = 0; d < n; d++) {
            if (tt[pos + d] != tt[prev + d]) return true;
            if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) return false;
        }
        return true;
    };
    I name = 0;
    if (nt <= 1 || n1 < (1 << 18)) {
        I prev = (I)-1;
        for (I i = 0; i < n1; i++) {
            if (i + 8 < n1) {
                I pp = sa[i + 8];
                __builtin_prefetch(tt + pp);
                __builtin_prefetch(sa + n1 + pp / 2, 1);
            }
            I pos = sa[i];
            if (prev == (I)-1 || differs(pos, prev)) {
                name++;
                prev = pos;
            }
            sa[n1 + pos / 2] = name - 1;
        }
    } else {
        // diff as a bit vector (n1 / 8 bytes), threads over whole words
        int64_t nw = (int64_t(n1) + 63) / 64;
        std::vector<uint64_t> diff(size_t(nw), 0);
        std::vector<int64_t> base(nt + 1, 0);
        par_ranges(nw, nt, [&](int64_t ws, int64_t we, int th) {
            int64_t m = 0;
            for (int64_t w = ws; w < we; w++) {
                uint64_t bits = 0;
                int64_t hi = std::min<int64_t>(int64_t(n1), w * 64 + 64);
                for (int64_t i = w * 64; i < hi; i++)
                    if (i == 0 || differs(sa[i], sa[i - 1]))
                        bits |= uint64_t(1) << (i & 63);
                diff[w] = bits;
                m += __builtin_popcountll(bits);
            }
            base[th + 1] = m;
        });
        for (int th = 0; th < nt; th++) base[th + 1] += base[th];
        name = (I)base[nt];
        par_ranges(nw, nt, [&](int64_t ws, int64_t we, int th) {
            I nm = (I)base[th];
            int64_t hi = std::min<int64_t>(int64_t(n1), we * 64);
            for (int64_t i = ws * 64; i < hi; i++) {
                nm += (diff[i >> 6] >> (i & 63)) & 1;
                sa[n1 + sa[i] / 2] = nm - 1;
            }
        });
    }
    // the names, in text order of their LMS positions, to the tail of sa
    compact_back(sa + n1, int64_t(n) - n1, nt);
    I* s1 = sa + n - n1;
    mark(NAMED, n1, depth);

    // step 3: sort the reduced problem (s1's last element is the
    // sentinel's name 0, unique and smallest, so the convention holds
    // recursively). Its free space is the gap between its SA and s1.
    if (name < n1) {
        fuse_types<I, I>([s1](I i) { return s1[i]; }, s1, n1, nt);
        sais_core<I, I>(s1, sa, n1, name, int64_t(n) - 2 * int64_t(n1), cx,
                        depth + 1);
    } else {
        par_ranges(int64_t(n1), nt, [&](int64_t s, int64_t e, int) {
            for (int64_t i = s; i < e; i++) sa[s1[i]] = (I)i;
        });
    }

    // step 4: s1 becomes the text-order table of LMS positions, and the
    // reduced SA in sa[0, n1) maps through it to text positions
    {
        std::vector<int64_t> c(nt + 1, 0);
        par_ranges(int64_t(n) - 1, nt, [&](int64_t s, int64_t e, int th) {
            int64_t m = 0;
            for (int64_t i = 1 + s; i < 1 + e; i++) m += is_lms((I)i);
            c[th + 1] = m;
        });
        for (int th = 0; th < nt; th++) c[th + 1] += c[th];
        par_ranges(int64_t(n) - 1, nt, [&](int64_t s, int64_t e, int th) {
            I* o = s1 + c[th];
            for (int64_t i = 1 + s; i < 1 + e; i++)
                if (is_lms((I)i)) *o++ = (I)i;
        });
    }
    par_ranges(int64_t(n1), nt, [&](int64_t s, int64_t e, int) {
        for (int64_t i = s; i < e; i++) {
            if (i + 16 < e) __builtin_prefetch(s1 + sa[i + 16]);
            sa[i] = s1[sa[i]];
        }
    });
    mark(MAPPED, n1, depth);

    // step 5: the sorted LMS to their bucket tails, in place: descending,
    // each lands at or past the slot it is read from, so every later slot
    // has been read before it can be overwritten
    par_fill_neg1<I>(sa, n1, n, nt);
    bk.tails();
    for (I i = n1 - 1;; i--) {
        if (i >= 16) __builtin_prefetch(tt + sa[i - 16]);
        I p = sa[i];
        sa[i] = (I)-1;
        sa[--bk.B[tt[p] >> 1]] = p;
        if (i == 0) break;
    }
    mark(FINAL_PLACE, n, depth);
    induce<I, TT>(tt, sa, bk, n);
    mark(DONE, n, depth);
}

struct Free {
    void operator()(uint8_t* p) const { std::free(p); }
};

// the largest of a[0, n), or -1 if some element exceeds lim (threads)
int64_t checked_max(const uint8_t* a, int64_t n, int lim, int nt) {
    std::vector<int64_t> mx(nt < 1 ? 1 : nt, 0);
    par_ranges(n, nt, [&](int64_t s, int64_t e, int th) {
        uint8_t m = 0;
        for (int64_t i = s; i < e; i++) m = std::max(m, a[i]);
        mx[th] = m;
    });
    int64_t m = *std::max_element(mx.begin(), mx.end());
    return m > lim ? -1 : m;
}

// The text t(i) = codes[i] + 1 for i < m, then the sentinel 0; sa has
// m + 1 entries.
template <typename I>
int sais_codes(const uint8_t* codes, I m, I* sa, int nt) {
    if (m < 0) return -1;
    nt = nt < 1 ? 1 : nt;
    int64_t cmax = checked_max(codes, m, 126, nt);
    if (cmax < 0) return -2;
    I n = m + 1;
    auto t = [codes, m](I i) {
        return i < m ? uint8_t(codes[i] + 1) : uint8_t(0);
    };
    std::unique_ptr<uint8_t, Free> tt(
        static_cast<uint8_t*>(std::malloc(size_t(n))));
    if (!tt) return -3;
    int nt_fuse = n < (1 << 20) ? 1 : nt;
    fuse_types<I, uint8_t>(t, tt.get(), n, nt_fuse);
    Ctx cx{nt, std::max<int64_t>(int64_t(n) / 8, 1 << 20)};
    sais_core<I, uint8_t>(tt.get(), sa, n, (I)cmax + 2, 0, cx, 0);
    return 0;
}

}  // namespace

extern "C" {

int sais_codes_i32_mt(const uint8_t* codes, int32_t m, int32_t* sa, int nt) {
    return sais_codes<int32_t>(codes, m, sa, nt);
}

int sais_codes_i64_mt(const uint8_t* codes, int64_t m, int64_t* sa, int nt) {
    return sais_codes<int64_t>(codes, m, sa, nt);
}

// Copies up to cap milestones, 5 int64 each (phase id, depth, n, peak RSS
// bytes, RSS bytes; phase ids index kPhaseName: enter, lms-placed,
// induce1, named, mapped, final-place, done); returns how many there are.
int64_t sais_marks(int64_t* out, int64_t cap) {
    std::lock_guard<std::mutex> g(g_mark_mu);
    int64_t m = int64_t(g_marks.size());
    for (int64_t i = 0; i < std::min(m, cap); i++) {
        const Mark& k = g_marks[size_t(i)];
        int64_t* o = out + 5 * i;
        o[0] = k.phase; o[1] = k.depth; o[2] = k.n; o[3] = k.hwm;
        o[4] = k.rss;
    }
    return m;
}

void sais_marks_clear() {
    std::lock_guard<std::mutex> g(g_mark_mu);
    g_marks.clear();
}

}  // extern "C"
