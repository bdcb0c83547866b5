// Multithreaded index-build helpers.
//
// The FM-index post-processing (after SA-IS) is bandwidth-bound array work
// that numpy runs single-threaded; the reference's builder is C as well
// (src/BWT_Index/bwt_gen.c, bwtindex.c). These kernels parallelize the
// three long poles: the big random context gather, the order-8 jump-table
// histogram, and the per-128-block symbol counts behind the occ / order-3
// checkpoints.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

int clamp_threads(int nt, int64_t n, int64_t min_per_thread) {
    if (nt < 1) nt = 1;
    int64_t cap = std::max<int64_t>(1, n / min_per_thread);
    if (nt > cap) nt = static_cast<int>(cap);
    return nt;
}

template <typename F>
void parallel_ranges(int64_t n, int nt, F f) {
    if (nt <= 1) {
        f(0, n, 0);
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

}  // namespace

extern "C" {

// out[i] = src[idx[i]] for i in [0, n)
void par_gather_u16_i32(const uint16_t* src, const int32_t* idx,
                        uint16_t* out, int64_t n, int nt) {
    nt = clamp_threads(nt, n, 1 << 20);
    parallel_ranges(n, nt, [&](int64_t s, int64_t e, int) {
        for (int64_t i = s; i < e; ++i) out[i] = src[idx[i]];
    });
}

void par_gather_u16_i64(const uint16_t* src, const int64_t* idx,
                        uint16_t* out, int64_t n, int nt) {
    nt = clamp_threads(nt, n, 1 << 20);
    parallel_ranges(n, nt, [&](int64_t s, int64_t e, int) {
        for (int64_t i = s; i < e; ++i) out[i] = src[idx[i]];
    });
}

// counts[key(i)] += 1 for i in [0, n]; key(i) = sum_j v(i+j) * 5^(7-j),
// v(x) = x < n ? text[x]+1 : 0  (the order-8 jump-table key space, matching
// fmindex._build_c8). counts has 5^8 = 390625 slots, pre-zeroed by caller.
void c8_counts(const uint8_t* text, int64_t n, int64_t* counts, int nt) {
    constexpr int64_t BINS = 390625;  // 5^8
    constexpr int64_t P7 = 78125;     // 5^7
    nt = clamp_threads(nt, n + 1, 1 << 20);
    std::vector<std::vector<int64_t>> local(nt);
    parallel_ranges(n + 1, nt, [&](int64_t s, int64_t e, int t) {
        std::vector<int64_t>& h = local[t];
        h.assign(BINS, 0);
        // rolling right-to-left: key(i) = v(i)*5^7 + (key(i+1) - v(i+8))/5
        auto v = [&](int64_t x) -> int64_t {
            return x < n ? int64_t(text[x]) + 1 : 0;
        };
        int64_t key = 0;  // key(e): compute directly
        for (int64_t j = 0; j < 8; ++j) key = key * 5 + v(e + j);
        for (int64_t i = e - 1; i >= s; --i) {
            key = v(i) * P7 + (key - v(i + 8)) / 5;
            ++h[key];
        }
    });
    for (int t = 0; t < nt; ++t) {
        if (local[t].empty()) continue;
        for (int64_t b = 0; b < BINS; ++b) counts[b] += local[t][b];
    }
}

// counts[key(i)] += 1 for i in [0, n-12]; key(i) = base-4 value of
// text[i..i+11] (the order-12 jump-table key space, fmindex._build_c12).
// counts has 4^12 slots, pre-zeroed by caller. No-op when n < 12.
void c12_counts(const uint8_t* text, int64_t n, int64_t* counts, int nt) {
    constexpr int64_t BINS = int64_t(1) << 24;  // 4^12
    int64_t total = n - 11;
    if (total <= 0) return;
    nt = clamp_threads(nt, total, 1 << 20);
    std::vector<std::vector<int64_t>> local(nt);
    parallel_ranges(total, nt, [&](int64_t s, int64_t e, int t) {
        std::vector<int64_t>& h = local[t];
        h.assign(BINS, 0);
        // rolling right-to-left: key(i) = t[i]*4^11 + key(i+1)/4
        int64_t key = 0;  // key(e) if e <= n-12, else recomputed per-entry
        for (int64_t j = 0; j < 12 && e + j < n; ++j)
            key |= int64_t(text[e + j]) << (2 * (11 - j));
        for (int64_t i = e - 1; i >= s; --i) {
            key = (int64_t(text[i]) << 22) | (key >> 2);
            ++h[key];
        }
    });
    // merge the per-thread 134 MB histograms in parallel over bin ranges
    parallel_ranges(BINS, nt, [&](int64_t bs, int64_t be, int) {
        for (int t = 0; t < nt; ++t) {
            if (local[t].empty()) continue;
            const int64_t* h = local[t].data();
            for (int64_t b = bs; b < be; ++b) counts[b] += h[b];
        }
    });
}

// Fused context build + SA gather + symbol extraction, one parallel pass:
//   ctx(p)   = packed (prev3,prev2,prev1,cur,nxt1,nxt2) context of text
//              position p (the uint16 layout of fmindex.build_fmindex)
//   g_ctx[i] = ctx(sa[i])
//   t3[i]    = order-3 symbol (ctx >> 9)
//   bcodes   = $-removed BWT: (t3 & 3) for rows with sa > 0 (the single
//              sa == 0 row sits at `primary`)
// idx variant chosen by idx_is64. g_ctx may be null: then only t3 and
// bcodes are written (the index build needs no more; 2 bytes a row less).
void ctx_gather_extract(const uint8_t* text, int64_t n, const void* sa,
                        int idx_is64, int64_t primary, uint16_t* g_ctx,
                        uint8_t* t3, uint8_t* bcodes, int nt) {
    const int32_t* sa32 = static_cast<const int32_t*>(sa);
    const int64_t* sa64 = static_cast<const int64_t*>(sa);
    int64_t rows = n + 1;
    nt = clamp_threads(nt, rows, 1 << 20);
    auto ctx_at = [&](int64_t p) -> uint16_t {
        uint16_t v = 0;
        if (p >= 3) v |= uint16_t(text[p - 3]) << 13;
        if (p >= 2) v |= uint16_t(text[p - 2]) << 11;
        if (p >= 1) v |= uint16_t(text[p - 1]) << 9;
        v |= uint16_t(p < n ? text[p] : 4) << 6;
        v |= uint16_t(p + 1 < n ? text[p + 1] : 4) << 3;
        v |= uint16_t(p + 2 < n ? text[p + 2] : 4);
        return v;
    };
    parallel_ranges(rows, nt, [&](int64_t s, int64_t e, int) {
        int64_t j = s - (s > primary ? 1 : 0);
        for (int64_t i = s; i < e; ++i) {
            if (i + 24 < e) {
                // the random text read is the latency bound: prefetch the
                // cacheline 24 rows ahead (covers p-3 .. p+2 almost always)
                int64_t pf = idx_is64 ? sa64[i + 24] : int64_t(sa32[i + 24]);
                __builtin_prefetch(text + (pf >= 3 ? pf - 3 : 0));
            }
            int64_t p = idx_is64 ? sa64[i] : int64_t(sa32[i]);
            uint16_t v = ctx_at(p);
            if (g_ctx) g_ctx[i] = v;
            uint8_t sym = uint8_t((v >> 9) & 0x3F);
            t3[i] = sym;
            if (p > 0) bcodes[j++] = sym & 3;
        }
    });
}

// Pack base codes (0..3) into uint32 words, 16 bases/word, BWA bit order
// (base k at bits (15 - k%16)*2). n_words = ceil(n/16), out pre-zeroed.
void pack_2bit(const uint8_t* codes, int64_t n, uint32_t* out, int nt) {
    int64_t n_words = (n + 15) >> 4;
    nt = clamp_threads(nt, n_words, 1 << 16);
    parallel_ranges(n_words, nt, [&](int64_t ws, int64_t we, int) {
        for (int64_t w = ws; w < we; ++w) {
            int64_t s = w << 4;
            int64_t e = std::min<int64_t>(n, s + 16);
            uint32_t acc = 0;
            for (int64_t i = s; i < e; ++i)
                acc |= uint32_t(codes[i]) << ((15 - (i & 15)) * 2);
            out[w] = acc;
        }
    });
}

// out[b*K + c] = #{ i in block b : vals[i] == c } over 128-element blocks
// (vals >= K ignored). out has ceil(n/128)*K slots, pre-zeroed by caller.
void block_counts_u8(const uint8_t* vals, int64_t n, int32_t K,
                     int64_t* out, int nt) {
    int64_t n_blocks = (n + 127) >> 7;
    nt = clamp_threads(nt, n_blocks, 1 << 13);
    parallel_ranges(n_blocks, nt, [&](int64_t bs, int64_t be, int) {
        for (int64_t b = bs; b < be; ++b) {
            int64_t s = b << 7;
            int64_t e = std::min<int64_t>(n, s + 128);
            int64_t* row = out + b * K;
            for (int64_t i = s; i < e; ++i) {
                uint8_t v = vals[i];
                if (v < K) ++row[v];
            }
        }
    });
}

// Segmented gather: out = concat_i src[starts[i] : starts[i] + lens[i]].
// offs[i] = sum of lens[:i] (precomputed exclusive cumsum, offs[k] = total).
void seg_gather_u8(const uint8_t* src, const int64_t* starts,
                   const int64_t* lens, const int64_t* offs, int64_t k,
                   uint8_t* out, int nt) {
    nt = clamp_threads(nt, k, 1 << 10);
    parallel_ranges(k, nt, [&](int64_t s, int64_t e, int) {
        for (int64_t i = s; i < e; ++i)
            std::memcpy(out + offs[i], src + starts[i], size_t(lens[i]));
    });
}

// Segmented mismatch scan over two NT4-code arrays: segment i compares
// qry[q_starts[i]+j] vs ref[r_starts[i]+j] for j < lens[i]; a mismatch is
// (qc != 4 && qc != rc) — exactly CheckFragPairMismatch (reference
// src/ProcessCandidateAlignment.cpp:49-61) and the SNV predicate
// (src/SeqVariant.cpp:56). Replaces the numpy chain (segment-index
// materialization + two full gathers + compare) that dominated the
// plan/variants host stages: no temporaries, memory-bandwidth-bound,
// threaded over segments.
void seg_mismatch_count(const uint8_t* qry, const uint8_t* ref,
                        const int64_t* q_starts, const int64_t* r_starts,
                        const int64_t* lens, int64_t k,
                        int64_t* counts, int nt) {
    nt = clamp_threads(nt, k, 1 << 8);
    parallel_ranges(k, nt, [&](int64_t s, int64_t e, int) {
        for (int64_t i = s; i < e; ++i) {
            const uint8_t* q = qry + q_starts[i];
            const uint8_t* r = ref + r_starts[i];
            int64_t n = lens[i];
            int64_t c = 0;
            for (int64_t j = 0; j < n; ++j)        // auto-vectorizes
                c += (q[j] != 4) & (q[j] != r[j]);
            counts[i] = c;
        }
    });
}

// Second pass: writes each segment's mismatch columns (int32, relative to
// the segment start) at cols + offs[i], where offs is the exclusive
// prefix sum of the counts from seg_mismatch_count.
void seg_mismatch_fill(const uint8_t* qry, const uint8_t* ref,
                       const int64_t* q_starts, const int64_t* r_starts,
                       const int64_t* lens, const int64_t* offs, int64_t k,
                       int32_t* cols, int nt) {
    nt = clamp_threads(nt, k, 1 << 8);
    parallel_ranges(k, nt, [&](int64_t s, int64_t e, int) {
        for (int64_t i = s; i < e; ++i) {
            const uint8_t* q = qry + q_starts[i];
            const uint8_t* r = ref + r_starts[i];
            int64_t n = lens[i];
            int32_t* out = cols + offs[i];
            for (int64_t j = 0; j < n; ++j)
                if ((q[j] != 4) & (q[j] != r[j])) *out++ = int32_t(j);
        }
    });
}

namespace {

// ReverseMap (reference src/tools.cpp:3-31): complement for ACGTUN
// upper/lower + '-'; everything else maps to 0, matching the numpy
// REVERSE_MAP table in pipeline/output.py.
struct CompTable {
    uint8_t m[256];
    CompTable() {
        std::memset(m, 0, sizeof(m));
        const int pairs[][2] = {{45, 45},  {65, 84},  {67, 71}, {71, 67},
                                {78, 78},  {84, 65},  {85, 65}, {97, 84},
                                {99, 71},  {103, 67}, {110, 78},
                                {116, 65}, {117, 65}};
        for (auto& p : pairs) m[p[0]] = uint8_t(p[1]);
    }
};
const CompTable kComp;

}  // namespace

// Fused MAF/ALN row assembly for one alignment block: ONE parallel pass
// over its pairs emits both aligned rows, the '-' counts, and (when rev)
// the reverse-complemented orientation — replacing the numpy
// copy-then-patch pipeline's six whole-row passes (OutputMAF semantics,
// reference src/tools.cpp:149-220).
//
// cls[j]: 0 seed  (both rows = query chars — the reference quirk),
//         1 direct (a1 = ref chars, a2 = query chars),
//         2 deletion (a1 = ref chars, a2 = '-'),
//         3 insertion (a1 = '-', a2 = query chars),
//         4 DP (rows copied from the dp1/dp2 per-pair pointers).
// Row positions >= emit_len are dropped (the chromosome-end clip). When
// rev != 0 rows land reverse-complemented: out[emit_len-1-i] = comp(x_i).
// gaps_out[0], gaps_out[1] = emitted '-' counts of a1, a2.
void maf_build_rows(const uint8_t* qry, const uint8_t* ref,
                    const int64_t* q_pos, const int64_t* r_pos,
                    const int64_t* row_len, const int64_t* offs,
                    const uint8_t* cls, int64_t n,
                    const uint8_t* const* dp1, const uint8_t* const* dp2,
                    int64_t emit_len, int rev, uint8_t* out1, uint8_t* out2,
                    int64_t* gaps_out, int nt) {
    nt = clamp_threads(nt, n, 1 << 9);
    std::vector<int64_t> g1(nt, 0), g2(nt, 0);
    parallel_ranges(n, nt, [&](int64_t s, int64_t e, int t) {
        int64_t gg1 = 0, gg2 = 0;
        for (int64_t j = s; j < e; ++j) {
            int64_t off = offs[j];
            int64_t lim = std::min(row_len[j], emit_len - off);
            if (lim <= 0) continue;
            uint8_t c = cls[j];
            const uint8_t* s1;
            const uint8_t* s2;
            switch (c) {
                case 0:  s1 = s2 = qry + q_pos[j]; break;
                case 1:  s1 = ref + r_pos[j]; s2 = qry + q_pos[j]; break;
                case 2:  s1 = ref + r_pos[j]; s2 = nullptr; break;
                case 3:  s1 = nullptr; s2 = qry + q_pos[j]; break;
                default: s1 = dp1[j]; s2 = dp2[j]; break;
            }
            // gap counts are LITERAL '-' counts over the emitted bytes for
            // every class (the numpy path's (row == '-').sum(), and what
            // the reference counts), not per-class arithmetic
            if (rev) {
                uint8_t* d1 = out1 + (emit_len - 1 - off);
                uint8_t* d2 = out2 + (emit_len - 1 - off);
                for (int64_t i = 0; i < lim; ++i) {
                    uint8_t v1 = s1 ? s1[i] : uint8_t('-');
                    uint8_t v2 = s2 ? s2[i] : uint8_t('-');
                    gg1 += v1 == '-';
                    gg2 += v2 == '-';
                    d1[-i] = kComp.m[v1];
                    d2[-i] = kComp.m[v2];
                }
            } else {
                uint8_t* d1 = out1 + off;
                uint8_t* d2 = out2 + off;
                if (s1) {
                    for (int64_t i = 0; i < lim; ++i) {  // auto-vectorizes
                        uint8_t v = s1[i];
                        d1[i] = v;
                        gg1 += v == '-';
                    }
                } else {
                    std::memset(d1, '-', size_t(lim));
                    gg1 += lim;
                }
                if (s2) {
                    for (int64_t i = 0; i < lim; ++i) {
                        uint8_t v = s2[i];
                        d2[i] = v;
                        gg2 += v == '-';
                    }
                } else {
                    std::memset(d2, '-', size_t(lim));
                    gg2 += lim;
                }
            }
        }
        g1[t] = gg1;
        g2[t] = gg2;
    });
    int64_t t1 = 0, t2 = 0;
    for (int t = 0; t < nt; ++t) { t1 += g1[t]; t2 += g2[t]; }
    gaps_out[0] = t1;
    gaps_out[1] = t2;
}

// Outlier-sweep trigger walk (pipeline/chain._outlier_pass): the interval
// bounds are a sequential recurrence over the unique-seed candidates (two
// binary searches per trigger); ~46k python iterations at 250 Mb move
// here. Returns the number of bounds written (caller appends n itself).
int64_t outlier_bounds(const int64_t* cand_k, const int64_t* cand_qp,
                       int64_t n_cand, const int64_t* q_pos,
                       const int64_t* u, int64_t u_size,
                       int64_t* bounds_out) {
    int64_t m = 0;
    bounds_out[m++] = 0;
    int64_t base = 0, i_full = 0;
    while (base + 29 < u_size) {
        const int64_t* p1 = std::lower_bound(cand_k, cand_k + n_cand,
                                             base + 29);
        const int64_t* p2 = std::upper_bound(cand_qp, cand_qp + n_cand,
                                             q_pos[i_full] + 3000);
        int64_t ci = std::max(p1 - cand_k, p2 - cand_qp);
        if (ci >= n_cand) break;
        int64_t k = cand_k[ci];
        int64_t j = u[k];
        bounds_out[m++] = j;
        i_full = j;
        base = k + 1;
    }
    return m;
}

// VCF body formatter (pipeline/variants.write_vcf): emits the sorted data
// lines "<name>\t<pos>\t.\t<ref>\t<alt>\t100\t*\tTYPE=<T>\n" into one
// buffer. The python f-string loop this replaces was ~1 s for 1.4 M lines
// at 250 Mb (the reference formats with fprintf, src/SeqVariant.cpp:135).
// Two passes: per-line byte lengths (parallel) -> exclusive scan ->
// parallel fill at exact offsets. Returns the total byte length, or -1 if
// it would exceed cap (caller re-sizes; the python bound makes this
// unreachable).
int64_t vcf_format(int64_t n, const int64_t* order, const int32_t* chrs,
                   const int64_t* pos, const uint8_t* name_buf,
                   const int64_t* name_off, int64_t n_snv,
                   const uint8_t* ref_c, const uint8_t* alt_c,
                   const uint8_t* frag_buf, const int64_t* frag_off,
                   const uint8_t* types, uint8_t* out, int64_t cap,
                   int nt) {
    static const char* TS[3] = {"SUBSTITUTE", "INSERT", "DELETE"};
    static const int64_t TSL[3] = {10, 6, 6};
    // fixed bytes: "\t" + "\t.\t" + "\t" + "\t100\t*\tTYPE=" + "\n" = 18
    auto dec_len = [](int64_t v) {
        int64_t l = 1;
        while (v >= 10) { v /= 10; ++l; }
        return l;
    };
    std::vector<int64_t> lens(size_t(n) + 1);
    nt = clamp_threads(nt, n, 1 << 16);
    parallel_ranges(n, nt, [&](int64_t s, int64_t e, int) {
        for (int64_t k = s; k < e; ++k) {
            int64_t i = order[k];
            int64_t name_l = name_off[chrs[i] + 1] - name_off[chrs[i]];
            int64_t ra_l, t_l;
            if (i < n_snv) {
                ra_l = 2;
                t_l = TSL[0];
            } else {
                int64_t j = i - n_snv;
                ra_l = (frag_off[2 * j + 1] - frag_off[2 * j])
                     + (frag_off[2 * j + 2] - frag_off[2 * j + 1]);
                t_l = TSL[types[j]];
            }
            lens[k] = name_l + dec_len(pos[i]) + ra_l + t_l + 18;
        }
    });
    int64_t total = 0;
    for (int64_t k = 0; k < n; ++k) {
        int64_t l = lens[k];
        lens[k] = total;
        total += l;
    }
    lens[n] = total;
    if (total > cap) return -1;
    parallel_ranges(n, nt, [&](int64_t s, int64_t e, int) {
        for (int64_t k = s; k < e; ++k) {
            int64_t i = order[k];
            uint8_t* p = out + lens[k];
            int64_t c = chrs[i];
            int64_t nl = name_off[c + 1] - name_off[c];
            std::memcpy(p, name_buf + name_off[c], size_t(nl));
            p += nl;
            *p++ = '\t';
            // decimal position (pos >= 0 always)
            char dig[24];
            int nd = 0;
            int64_t v = pos[i];
            do { dig[nd++] = char('0' + v % 10); v /= 10; } while (v);
            while (nd) *p++ = dig[--nd];
            std::memcpy(p, "\t.\t", 3);
            p += 3;
            const char* ts;
            int64_t tsl;
            if (i < n_snv) {
                *p++ = ref_c[i];
                *p++ = '\t';
                *p++ = alt_c[i];
                ts = TS[0];
                tsl = TSL[0];
            } else {
                int64_t j = i - n_snv;
                int64_t rl = frag_off[2 * j + 1] - frag_off[2 * j];
                int64_t al = frag_off[2 * j + 2] - frag_off[2 * j + 1];
                std::memcpy(p, frag_buf + frag_off[2 * j], size_t(rl));
                p += rl;
                *p++ = '\t';
                std::memcpy(p, frag_buf + frag_off[2 * j + 1], size_t(al));
                p += al;
                ts = TS[types[j]];
                tsl = TSL[types[j]];
            }
            std::memcpy(p, "\t100\t*\tTYPE=", 12);
            p += 12;
            std::memcpy(p, ts, size_t(tsl));
            p += tsl;
            *p++ = '\n';
        }
    });
    return total;
}

}  // extern "C"
