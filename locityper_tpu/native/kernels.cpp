// Native host kernels for locityper-tpu.
//
// The reference implements its host runtime in Rust (seq/kmers.rs scalar
// rolling loops, fastx readers over htslib); this library provides the
// C++ equivalents behind a C ABI consumed via ctypes
// (locityper_tpu/native/__init__.py), with identical semantics to the numpy
// fallbacks in seq/kmers.py — parity is enforced by tests/test_native.py.
//
// Build: make -C locityper_tpu/native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// DNA encoding: byte -> code (A=0 C=1 G=2 T=3, other=4).
// ---------------------------------------------------------------------------
static int8_t ENC[256];
static bool enc_init = false;

static void init_enc() {
    if (enc_init) return;
    memset(ENC, 4, sizeof(ENC));
    ENC[(unsigned char)'A'] = 0; ENC[(unsigned char)'a'] = 0;
    ENC[(unsigned char)'C'] = 1; ENC[(unsigned char)'c'] = 1;
    ENC[(unsigned char)'G'] = 2; ENC[(unsigned char)'g'] = 2;
    ENC[(unsigned char)'T'] = 3; ENC[(unsigned char)'t'] = 3;
    enc_init = true;
}

void encode_dna(const uint8_t* seq, int64_t n, int8_t* out) {
    init_enc();
    for (int64_t i = 0; i < n; i++) out[i] = ENC[seq[i]];
}

// ---------------------------------------------------------------------------
// 4-bit base packing for device upload (ops/recruit.py pack_reads_host):
// [n, l] int8 codes (0-4, l % 8 == 0) -> [n, l/8] uint32, little-endian
// nibbles: half the H2D bytes of int8 codes.
// ---------------------------------------------------------------------------
static inline void pack_row4(const uint8_t* s, uint32_t* d, int64_t wpr) {
    for (int64_t j = 0; j < wpr; j++) {
        const uint8_t* p = s + j * 8;
        d[j] = (uint32_t)(p[0] | (p[1] << 4))
             | ((uint32_t)(p[2] | (p[3] << 4)) << 8)
             | ((uint32_t)(p[4] | (p[5] << 4)) << 16)
             | ((uint32_t)(p[6] | (p[7] << 4)) << 24);
    }
}

void pack_codes4(const int8_t* codes, int64_t n, int64_t l, uint32_t* out) {
    const int64_t wpr = l / 8;
    for (int64_t i = 0; i < n; i++)
        pack_row4((const uint8_t*)(codes + i * l), out + i * wpr, wpr);
}

// Strided variant: row i of `codes` packs into
// out[i * stride_words + col_off .. + l/8] — several matrices (reads,
// windows) interleave into ONE combined upload buffer (model/locs.py
// _pack_align_jobs_host).
void pack_codes4s(const int8_t* codes, int64_t n, int64_t l, uint32_t* out,
                  int64_t stride_words, int64_t col_off) {
    const int64_t wpr = l / 8;
    for (int64_t i = 0; i < n; i++)
        pack_row4((const uint8_t*)(codes + i * l),
                  out + i * stride_words + col_off, wpr);
}

// ---------------------------------------------------------------------------
// Canonical k-mers (seq/kmers.py canonical_kmers): out_kmer[i] = canonical
// 2-bit packed k-mer at position i (UINT64_MAX when any base invalid),
// out_valid[i] in {0,1}.  k <= 31.
// ---------------------------------------------------------------------------
void canonical_kmers(const int8_t* codes, int64_t n, int32_t k,
                     uint64_t* out_kmer, uint8_t* out_valid,
                     uint8_t* out_fwd) {
    const uint64_t UNDEF = ~0ULL;
    const int64_t m = n - k + 1;
    if (m <= 0) return;
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int rv_shift = 2 * (k - 1);
    uint64_t fw = 0, rv = 0;
    int64_t since_invalid = 0;  // consecutive valid bases ending at i
    for (int64_t i = 0; i < n; i++) {
        int8_t c = codes[i];
        if (c < 4) {
            fw = ((fw << 2) | (uint64_t)c) & mask;
            rv = (rv >> 2) | ((uint64_t)(3 - c) << rv_shift);
            since_invalid++;
        } else {
            fw = 0; rv = 0; since_invalid = 0;
        }
        int64_t pos = i - k + 1;
        if (pos >= 0) {
            if (since_invalid >= k) {
                out_kmer[pos] = fw <= rv ? fw : rv;
                out_valid[pos] = 1;
                out_fwd[pos] = fw <= rv;
            } else {
                out_kmer[pos] = UNDEF;
                out_valid[pos] = 0;
                out_fwd[pos] = 1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// 32-bit minimizers (seq/kmers.py minimizers32): canonical k-mer (k <= 16)
// -> murmur3 mix -> first-argmin per w-window, deduplicated by position.
// Returns the number of minimizers written.
// ---------------------------------------------------------------------------
static inline uint32_t murmur3_mix32(uint32_t x) {
    x = ~x;
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    return x;
}

int64_t minimizers32(const int8_t* codes, int64_t n, int32_t k, int32_t w,
                     int64_t* out_pos, uint32_t* out_hash, uint8_t* out_fwd) {
    const uint32_t UNDEF = 0xFFFFFFFFu;
    const int64_t m = n - k + 1;
    if (m < w) return 0;

    // Rolling hash buffer (ring of size >= w).
    const int64_t RING = 64;  // w < 64 always
    uint32_t hash_ring[RING];
    uint8_t fwd_ring[RING];

    const uint32_t mask = (uint32_t)((1ULL << (2 * k)) - 1);
    const int rv_shift = 2 * (k - 1);
    uint32_t fw = 0, rv = 0;
    int64_t since_invalid = 0;
    int64_t count = 0;
    int64_t last_out = -1;

    // Fill hashes incrementally; emit window results once i >= k-1+w-1.
    for (int64_t i = 0; i < n; i++) {
        int8_t c = codes[i];
        if (c < 4) {
            fw = ((fw << 2) | (uint32_t)c) & mask;
            rv = (rv >> 2) | ((uint32_t)(3 - c) << rv_shift);
            since_invalid++;
        } else {
            fw = 0; rv = 0; since_invalid = 0;
        }
        int64_t pos = i - k + 1;
        if (pos < 0) continue;
        bool valid = since_invalid >= k;
        bool is_fw = fw <= rv;
        uint32_t kmer = is_fw ? fw : rv;
        hash_ring[pos % RING] = valid ? murmur3_mix32(kmer) : UNDEF;
        fwd_ring[pos % RING] = is_fw ? 1 : 0;

        int64_t win_start = pos - w + 1;
        if (win_start < 0) continue;
        // First-argmin over [win_start, pos].
        uint32_t best = UNDEF;
        int64_t best_p = -1;
        for (int64_t p = win_start; p <= pos; p++) {
            uint32_t h = hash_ring[p % RING];
            if (h < best) { best = h; best_p = p; }
        }
        if (best == UNDEF) continue;
        if (best_p > last_out) {
            out_pos[count] = best_p;
            out_hash[count] = best;
            out_fwd[count] = fwd_ring[best_p % RING];
            count++;
            last_out = best_p;
        }
    }
    return count;
}

// ---------------------------------------------------------------------------
// FASTQ chunk parser: splits a decompressed FASTQ text buffer into encoded
// reads.  Records must be complete 4-line records.  Returns #reads parsed;
// out_codes is a flat buffer (each read padded to max_len with 4s),
// out_lens the stored (possibly clipped) lengths, out_name_off/out_name_len
// index into buf.  max_seen_out (nullable) reports the maximum TRUE sequence
// length encountered so callers can detect clipping and re-size max_len —
// the reference recruiter always sees full reads (recruit.rs:852-932).
// ---------------------------------------------------------------------------
int64_t parse_fastq(const uint8_t* buf, int64_t n, int32_t max_len,
                    int64_t max_reads, int8_t* out_codes, int32_t* out_lens,
                    int64_t* out_name_off, int32_t* out_name_len,
                    int64_t* consumed_out, int32_t* max_seen_out) {
    init_enc();
    int64_t i = 0, r = 0;
    if (consumed_out) *consumed_out = 0;
    while (i < n && r < max_reads) {
        int64_t rec_start = i;
        (void)rec_start;
        if (buf[i] != '@') break;
        int64_t name_start = i + 1;
        while (i < n && buf[i] != '\n') i++;
        if (i >= n) break;
        int64_t name_end = name_start;
        while (name_end < n && buf[name_end] != ' ' && buf[name_end] != '\n'
               && buf[name_end] != '\t') name_end++;
        i++;  // skip newline
        int64_t seq_start = i;
        while (i < n && buf[i] != '\n') i++;
        if (i >= n) break;
        int64_t seq_len = i - seq_start;
        i++;
        if (i >= n || buf[i] != '+') break;
        while (i < n && buf[i] != '\n') i++;
        if (i >= n) break;
        i++;
        int64_t qual_start = i;
        while (i < n && buf[i] != '\n') i++;
        if (i - qual_start != seq_len) break;  // malformed
        if (i < n) i++;

        if (max_seen_out && seq_len > *max_seen_out)
            *max_seen_out = (int32_t)seq_len;
        int32_t L = seq_len < max_len ? (int32_t)seq_len : max_len;
        int8_t* dst = out_codes + r * (int64_t)max_len;
        for (int32_t j = 0; j < L; j++) dst[j] = ENC[buf[seq_start + j]];
        for (int32_t j = L; j < max_len; j++) dst[j] = 4;
        out_lens[r] = L;
        out_name_off[r] = name_start;
        out_name_len[r] = (int32_t)(name_end - name_start);
        r++;
        if (consumed_out) *consumed_out = i;
    }
    return r;
}

// ---------------------------------------------------------------------------
// Batched minimizers: one call for a whole read batch (concatenated codes +
// offsets), emitting (read_ix, pos, hash, fwd) tuples.  Avoids per-read FFI
// overhead in the candidate generator (model/locs.py candidates_batch).
// ---------------------------------------------------------------------------
int64_t minimizers32_batch(const int8_t* codes, const int64_t* offsets,
                           int64_t n_reads, int32_t k, int32_t w,
                           int64_t* out_read, int64_t* out_pos,
                           uint32_t* out_hash, uint8_t* out_fwd,
                           int64_t cap) {
    int64_t total = 0;
    for (int64_t r = 0; r < n_reads; r++) {
        const int8_t* seq = codes + offsets[r];
        int64_t n = offsets[r + 1] - offsets[r];
        if (total + (n > 0 ? n : 0) > cap) return -1;   // minimizers <= n
        int64_t cnt = minimizers32(seq, n, k, w, out_pos + total,
                                   out_hash + total, out_fwd + total);
        for (int64_t j = 0; j < cnt; j++) out_read[total + j] = r;
        total += cnt;
    }
    return total;
}

// ---------------------------------------------------------------------------
// Non-overlapping unique-k-mer count (model/locs.rs:958-992 / UniqueKmers
// .count_read): rolling canonical k-mers, membership in a sorted unique
// table, greedy k-step skip after each hit.
// ---------------------------------------------------------------------------
int64_t count_unique_nonoverlap(const int8_t* codes, int64_t n, int32_t k,
                                const uint64_t* uniq, int64_t m) {
    if (n < k || m == 0) return 0;
    const int64_t n_kmers = n - k + 1;
    // Compute canonical kmers into a small stack/heap buffer.
    uint64_t* km = new uint64_t[n_kmers];
    uint8_t* ok = new uint8_t[n_kmers];
    uint8_t* fwd = new uint8_t[n_kmers];
    canonical_kmers(codes, n, k, km, ok, fwd);
    delete[] fwd;
    int64_t count = 0;
    for (int64_t t = 0; t < n_kmers; ) {
        bool hit = false;
        if (ok[t]) {
            // Binary search in uniq.
            int64_t lo = 0, hi = m;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (uniq[mid] < km[t]) lo = mid + 1;
                else hi = mid;
            }
            hit = lo < m && uniq[lo] == km[t];
        }
        if (hit) { count++; t += k; }
        else t++;
    }
    delete[] km; delete[] ok;
    return count;
}

// Batched variant: one call for a whole read set (flat codes + offsets),
// amortizing the Python/ctypes boundary over the batch.
void count_unique_nonoverlap_batch(const int8_t* codes, const int64_t* offsets,
                                   int64_t n_reads, int32_t k,
                                   const uint64_t* uniq, int64_t m,
                                   int64_t* out) {
    for (int64_t r = 0; r < n_reads; r++) {
        out[r] = count_unique_nonoverlap(codes + offsets[r],
                                         offsets[r + 1] - offsets[r], k,
                                         uniq, m);
    }
}

// ---------------------------------------------------------------------------
// Banded ML alignment WITH traceback (host twin of ops/align.py _align_one;
// reference role: WFA2-lib seq/wfa.rs + cigar.rs — CIGAR production for
// PAF/SAM output).  Same recurrence and tie-breaking as the device kernel:
//   band offset j in [0, band): read prefix i consumed -> target prefix i+j
//   row 0 free (glocal start), moves diag/ins/clip-start, then a within-row
//   deletion pass; end folds (qlen-i)*clip tail soft-clip.
// Tie-breaking parity: diag > ins > clip (strict > to replace); deletion
// taken only when strictly better than the local base (no_del restore).
//
// Outputs extended-CIGAR ops (0 '=', 1 'X', 2 'I', 3 'D', 4 'S') and the
// same payload vector as the device kernel.  Returns #ops, or -1 when the
// DP exceeds max_cells / op buffer.
// ---------------------------------------------------------------------------
static const float NEG_SCORE = -1e30f;

int64_t banded_align_cigar(const int8_t* query, int64_t qlen,
                           const int8_t* twin, int64_t wlen,
                           int32_t band, const float* sc,
                           int64_t max_cells,
                           int32_t* out_ops, int32_t* out_lens,
                           int64_t max_ops,
                           int32_t* out_info, float* out_score) {
    if (qlen <= 0 || band <= 0 || wlen < qlen + band) return -1;
    if ((qlen + 1) * (int64_t)band > max_cells) return -1;
    const float m_sc = sc[0], x_sc = sc[1], i_sc = sc[2], d_sc = sc[3],
                c_sc = sc[4];

    float* prev = new float[band];
    float* cur = new float[band];
    // Per-cell backpointers: base move (2 bits) | del jump << 2.
    uint16_t* bp = new uint16_t[(qlen + 1) * (int64_t)band];
    for (int32_t j = 0; j < band; j++) prev[j] = 0.0f;

    float best_score = NEG_SCORE;
    int64_t best_i = 0;
    int32_t best_j = 0;

    for (int64_t i = 1; i <= qlen; i++) {
        int8_t r_c = query[i - 1];
        uint16_t* brow = bp + i * (int64_t)band;
        const float clip_s = c_sc * (float)i;
        for (int32_t j = 0; j < band; j++) {
            int8_t h_c = twin[i - 1 + j];
            float sub = (h_c < 4 && r_c < 4)
                            ? (r_c == h_c ? m_sc : x_sc) : NEG_SCORE;
            float s = prev[j] + sub;           // diag
            uint16_t mv = 0;
            float ins_s = (j + 1 < band ? prev[j + 1] : NEG_SCORE) + i_sc;
            if (ins_s > s) { s = ins_s; mv = 1; }
            if (clip_s > s) { s = clip_s; mv = 2; }
            cur[j] = s;
            brow[j] = mv;
        }
        // Within-row deletion pass (max-plus prefix scan, ties keep base).
        float run = cur[0] - 0.0f;  // adjusted[0]
        int32_t origin = 0;
        for (int32_t j = 1; j < band; j++) {
            float adj = cur[j] - (float)j * d_sc;
            if (adj >= run) { run = adj; origin = j; }
            else {
                int32_t dj = j - origin;
                cur[j] = run + (float)j * d_sc;
                brow[j] = (uint16_t)(brow[origin] | ((uint32_t)dj << 2));
            }
        }
        // Fold tail clip.
        const float end_bonus = c_sc * (float)(qlen - i);
        for (int32_t j = 0; j < band; j++) {
            float cand = cur[j] + end_bonus;
            if (cand > best_score) { best_score = cand; best_i = i; best_j = j; }
        }
        float* t = prev; prev = cur; cur = t;
    }

    // Traceback from (best_i, best_j); ops emitted reversed, RLE on the fly.
    int64_t n_ops = 0;
    int32_t n_mism = 0, n_ins = 0, n_del = 0, n_clip = 0;
    int32_t start_p = 0, end_p = (int32_t)(best_i + best_j);
    bool fail = best_score <= NEG_SCORE / 2;

    // push-front helper (we reverse at the end).
    #define PUSH(op, len) do { \
        if (n_ops > 0 && out_ops[n_ops - 1] == (op)) out_lens[n_ops - 1] += (len); \
        else if (n_ops < max_ops) { out_ops[n_ops] = (op); out_lens[n_ops] = (len); n_ops++; } \
        else { fail = true; } \
    } while (0)

    if (!fail) {
        if (best_i < qlen) { PUSH(4, (int32_t)(qlen - best_i)); n_clip += (int32_t)(qlen - best_i); }
        int64_t i = best_i;
        int32_t j = best_j;
        while (i > 0 && !fail) {
            uint16_t cell = bp[i * (int64_t)band + j];
            int32_t dj = cell >> 2;
            if (dj > 0) { PUSH(3, dj); n_del += dj; j -= dj; cell = bp[i * (int64_t)band + j]; }
            uint16_t mv = cell & 3;
            if (mv == 0) {
                bool mism = query[i - 1] != twin[i - 1 + j];
                PUSH(mism ? 1 : 0, 1);
                if (mism) n_mism++;
                i--;
            } else if (mv == 1) {
                PUSH(2, 1); n_ins++;
                i--; j++;
            } else {  // clip-start: first i bases of the read soft-clipped
                PUSH(4, (int32_t)i); n_clip += (int32_t)i;
                start_p = (int32_t)(i + j);
                i = 0; j = -1;  // j unused past here
            }
        }
        if (j >= 0) start_p = j;
    }
    #undef PUSH

    delete[] prev; delete[] cur; delete[] bp;
    if (fail) return -1;
    // Reverse the op list in place.
    for (int64_t a = 0, b = n_ops - 1; a < b; a++, b--) {
        int32_t t1 = out_ops[a]; out_ops[a] = out_ops[b]; out_ops[b] = t1;
        int32_t t2 = out_lens[a]; out_lens[a] = out_lens[b]; out_lens[b] = t2;
    }
    out_info[0] = start_p; out_info[1] = end_p;
    out_info[2] = n_mism; out_info[3] = n_ins;
    out_info[4] = n_del; out_info[5] = n_clip;
    *out_score = best_score;
    return n_ops;
}

// ---------------------------------------------------------------------------
// Anchor voting (host twin of model/locs.py candidates_batch_flat, numpy
// fallback path; reference role: strobealign seeding inside recruit/locs).
// For each read's minimizers: binary-search the panel index, expand matching
// entries to (hap, orient, diagonal) anchors, vote per (hap, orient,
// diagonal-bucket), keep buckets with >= min_votes, and emit the top
// max_per_hap buckets per (hap, orient) by votes (ties: bucket ascending) —
// bit-identical ordering and rounding to the numpy path
// (tests/test_model_units.py parity).
// Returns rows written, or -1 if cap would be exceeded.
// ---------------------------------------------------------------------------

}  // extern "C" (pause: C++ internals below)

#include <algorithm>
#include <cmath>
#include <thread>
#include <vector>

namespace {

struct Anchor {
    uint64_t key;    // (hap << 33) | (orient << 32) | biased bucket
    int64_t diag;
};

static inline int64_t floordiv64(int64_t a, int64_t b) {
    int64_t q = a / b, r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

struct Group {
    int64_t hap;
    int64_t orient;
    int64_t votes;
    int64_t diag;
};

static void anchor_votes_range(
    int64_t r_lo, int64_t r_hi, const int64_t* rstart,
    const int64_t* mpos, const uint32_t* mhash, const uint8_t* mfwd,
    const int64_t* rlens,
    const uint32_t* keys, const int32_t* ihap, const int32_t* ipos,
    const uint8_t* ifwd, int64_t n_idx,
    int32_t k, int32_t bstep, int32_t min_votes, int32_t max_per_hap,
    std::vector<int64_t>& out) {
    std::vector<Anchor> anchors;
    std::vector<Group> groups;
    for (int64_t r = r_lo; r < r_hi; r++) {
        anchors.clear();
        groups.clear();
        const int64_t rlen = rlens[r];
        for (int64_t t = rstart[r]; t < rstart[r + 1]; t++) {
            const uint32_t h = mhash[t];
            // lower_bound / upper_bound over the sorted key table.
            int64_t lo = std::lower_bound(keys, keys + n_idx, h) - keys;
            for (int64_t e = lo; e < n_idx && keys[e] == h; e++) {
                const bool same = (ifwd[e] != 0) == (mfwd[t] != 0);
                int64_t diag;
                int64_t orient;
                if (same) {
                    orient = 0;
                    diag = (int64_t)ipos[e] - mpos[t];
                } else {
                    orient = 1;
                    diag = (int64_t)ipos[e] - (rlen - k - mpos[t]);
                }
                const int64_t bucket = floordiv64(diag, bstep);
                const uint64_t key = ((uint64_t)ihap[e] << 33)
                    | ((uint64_t)orient << 32)
                    | (uint32_t)((int32_t)bucket ^ (int32_t)0x80000000);
                anchors.push_back({key, diag});
            }
        }
        if (anchors.empty()) continue;
        std::sort(anchors.begin(), anchors.end(),
                  [](const Anchor& a, const Anchor& b) {
                      return a.key < b.key;
                  });
        // Run-length vote per (hap, orient, bucket).
        for (size_t s = 0; s < anchors.size();) {
            size_t e = s;
            int64_t dsum = 0;
            while (e < anchors.size() && anchors[e].key == anchors[s].key) {
                dsum += anchors[e].diag;
                e++;
            }
            const int64_t votes = (int64_t)(e - s);
            if (votes >= min_votes) {
                const int64_t hap = (int64_t)(anchors[s].key >> 33);
                const int64_t orient = (anchors[s].key >> 32) & 1;
                // round-half-even, matching np.round(dsum / votes).
                const int64_t diag = (int64_t)std::nearbyint(
                    (double)dsum / (double)votes);
                groups.push_back({hap, orient, votes, diag});
            }
            s = e;
        }
        // Top max_per_hap per (hap, orient) by votes desc; stable sort keeps
        // bucket-ascending order among equal-vote groups.
        std::stable_sort(groups.begin(), groups.end(),
                         [](const Group& a, const Group& b) {
                             if (a.hap != b.hap) return a.hap < b.hap;
                             if (a.orient != b.orient)
                                 return a.orient < b.orient;
                             return a.votes > b.votes;
                         });
        int64_t prev_hap = -1, prev_or = -1, taken = 0;
        for (const Group& g : groups) {
            if (g.hap != prev_hap || g.orient != prev_or) {
                prev_hap = g.hap;
                prev_or = g.orient;
                taken = 0;
            }
            if (taken < max_per_hap) {
                out.push_back(r);
                out.push_back(g.hap);
                out.push_back(g.orient);
                out.push_back(g.diag);
                taken++;
            }
        }
    }
}

}  // namespace

extern "C" {

int64_t anchor_votes(const int64_t* mread, const int64_t* mpos,
                     const uint32_t* mhash, const uint8_t* mfwd, int64_t T,
                     const int64_t* rlens, int64_t n_reads,
                     const uint32_t* keys, const int32_t* ihap,
                     const int32_t* ipos, const uint8_t* ifwd, int64_t n_idx,
                     int32_t k, int32_t bstep, int32_t min_votes,
                     int32_t max_per_hap,
                     int64_t* out_read, int64_t* out_hap, int64_t* out_orient,
                     int64_t* out_diag, int64_t cap) {
    // Per-read minimizer spans (mread is sorted ascending).
    std::vector<int64_t> rstart(n_reads + 1, 0);
    for (int64_t t = 0; t < T; t++) rstart[mread[t] + 1]++;
    for (int64_t r = 0; r < n_reads; r++) rstart[r + 1] += rstart[r];

    int n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 8) n_threads = 8;
    if (n_reads < 256) n_threads = 1;
    std::vector<std::vector<int64_t>> parts(n_threads);
    std::vector<std::thread> threads;
    const int64_t chunk = (n_reads + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; i++) {
        const int64_t lo = i * chunk;
        const int64_t hi = std::min(n_reads, lo + chunk);
        if (lo >= hi) continue;
        threads.emplace_back(anchor_votes_range, lo, hi, rstart.data(),
                             mpos, mhash, mfwd, rlens, keys, ihap, ipos,
                             ifwd, n_idx, k, bstep, min_votes, max_per_hap,
                             std::ref(parts[i]));
    }
    for (auto& th : threads) th.join();
    int64_t total = 0;
    for (auto& p : parts) total += (int64_t)(p.size() / 4);
    if (total > cap) return -1;
    int64_t w = 0;
    for (auto& p : parts) {
        for (size_t s = 0; s < p.size(); s += 4) {
            out_read[w] = p[s];
            out_hap[w] = p[s + 1];
            out_orient[w] = p[s + 2];
            out_diag[w] = p[s + 3];
            w++;
        }
    }
    return total;
}

// Bytes consumed by complete FASTQ records within buf[0..n) (for chunked IO).
int64_t fastq_complete_prefix(const uint8_t* buf, int64_t n) {
    int64_t i = 0, last_complete = 0;
    while (i < n) {
        int64_t start = i;
        int nl = 0;
        while (i < n && nl < 4) {
            if (buf[i] == '\n') nl++;
            i++;
        }
        if (nl == 4) last_complete = i;
        else { i = start; break; }
    }
    return last_complete;
}

}  // extern "C" (pause: chained hap-hap alignment internals below)

// ===========================================================================
// Chained haplotype-haplotype alignment (counterpart of reference
// seq/dist.rs:115-271 + seq/wfa.rs smart_align/align_simple).  The reference
// matches exact non-canonical U256 k-mers (k in {25,51,101}), chains them
// with LCSk++ (bio::alignment::sparse::lcskpp), and fills inter-anchor gaps
// with WFA gap-affine alignment.  Here: 128-bit rolling fingerprints with
// exact memcmp verification stand in for U256 k-mers, the LCSk++ event-sweep
// DP with a Fenwick max-tree reproduces rust-bio's algorithm, and gap fill
// uses a Gotoh affine-gap global DP (same scoring model as WFA gap-affine:
// match 0, mismatch -x, gap -(o+e*len), no I<->D transitions).
// ===========================================================================

namespace hapdist {

struct FpEntry {
    uint64_t hi, lo;
    uint32_t pos;
};

// Fenwick tree holding prefix maxima of (value, idx) pairs.
struct MaxBitTree {
    std::vector<uint64_t> t;  // packed (value << 32) | idx
    explicit MaxBitTree(size_t n) : t(n + 2, 0) {}
    void set(size_t i, uint64_t packed) {
        for (i += 1; i < t.size(); i += i & (~i + 1))
            if (packed > t[i]) t[i] = packed;
    }
    uint64_t get(size_t i) const {
        uint64_t best = 0;
        for (i += 1; i > 0; i -= i & (~i + 1))
            if (t[i] > best) best = t[i];
        return best;
    }
};

struct Event {
    uint32_t x, y, code;
    bool operator<(const Event& o) const {
        if (x != o.x) return x < o.x;
        if (y != o.y) return y < o.y;
        return code < o.code;
    }
};

// LCSk++ over sorted (pos1, pos2) matches; fills `path` with indices of the
// chained matches in increasing order.  Mirrors rust-bio sparse::lcskpp
// (dist.rs:204): start events query the prefix-max tree, end events insert
// and check the k+1-extension continuation via binary search for
// (x-1, y-1).
static void lcskpp(const uint32_t* ap1, const uint32_t* ap2, int64_t n,
                   uint32_t k, std::vector<int64_t>& path) {
    path.clear();
    if (n == 0) return;
    std::vector<Event> events;
    events.reserve(2 * (size_t)n);
    uint32_t max_n = 0;
    for (int64_t i = 0; i < n; i++) {
        events.push_back({ap1[i], ap2[i], (uint32_t)(i + n)});
        events.push_back({ap1[i] + k, ap2[i] + k, (uint32_t)i});
        if (ap1[i] + k > max_n) max_n = ap1[i] + k;
        if (ap2[i] + k > max_n) max_n = ap2[i] + k;
    }
    std::sort(events.begin(), events.end());

    MaxBitTree tree((size_t)max_n + 1);
    std::vector<uint32_t> dp_val((size_t)n, 0);
    std::vector<int64_t> dp_prev((size_t)n, -1);
    uint32_t best_val = 0;
    int64_t best_idx = 0;

    for (const Event& ev : events) {
        const int64_t p = (int64_t)(ev.code % (uint32_t)n);
        const size_t j = (size_t)ev.y + 1;
        if (ev.code >= (uint32_t)n) {
            // Start of a match.
            dp_val[p] = k;
            dp_prev[p] = -1;
            const uint64_t packed = tree.get(j);
            const uint32_t value = (uint32_t)(packed >> 32);
            if (value > 0) {
                dp_val[p] = k + value;
                dp_prev[p] = (int64_t)(uint32_t)packed;
            }
            if (dp_val[p] > best_val) { best_val = dp_val[p]; best_idx = p; }
        } else {
            // End of a match: check continuation from (x-1, y-1).
            if (ev.x > k && ev.y > k) {
                const uint32_t cx = ev.x - k - 1, cy = ev.y - k - 1;
                int64_t lo = 0, hi = n - 1, found = -1;
                while (lo <= hi) {
                    const int64_t mid = (lo + hi) / 2;
                    if (ap1[mid] < cx || (ap1[mid] == cx && ap2[mid] < cy))
                        lo = mid + 1;
                    else if (ap1[mid] == cx && ap2[mid] == cy) {
                        found = mid;
                        break;
                    } else
                        hi = mid - 1;
                }
                if (found >= 0 && dp_val[found] + 1 > dp_val[p]) {
                    dp_val[p] = dp_val[found] + 1;
                    dp_prev[p] = found;
                    if (dp_val[p] > best_val) {
                        best_val = dp_val[p];
                        best_idx = p;
                    }
                }
            }
            tree.set(j, ((uint64_t)dp_val[p] << 32) | (uint64_t)(uint32_t)p);
        }
    }
    for (int64_t q = best_idx; q >= 0; q = dp_prev[q]) path.push_back(q);
    std::reverse(path.begin(), path.end());
}

// Extended-CIGAR builder with run merging.  Op codes match
// banded_align_cigar: 0 '=', 1 'X', 2 'I' (consumes query/seq2),
// 3 'D' (consumes ref/seq1).
struct CigarBuf {
    std::vector<int32_t> ops, lens;
    void push(int32_t op, int64_t len) {
        if (len <= 0) return;
        if (!ops.empty() && ops.back() == op)
            lens.back() += (int32_t)len;
        else {
            ops.push_back(op);
            lens.push_back((int32_t)len);
        }
    }
};

// align_simple (wfa.rs:50-85): one leading INS/DEL equalizing lengths,
// then a straight =/X run.  Returns the score.
static int64_t align_simple(const int8_t* s1, int64_t a, const int8_t* s2,
                            int64_t b, int32_t mm, int32_t go, int32_t ge,
                            CigarBuf& cig) {
    int64_t score = 0;
    int64_t i = 0, j = 0;
    const int64_t diff = a - b;
    if (diff < 0) {
        cig.push(2, -diff);
        score = -(int64_t)go + diff * ge;
        j = -diff;
    } else if (diff > 0) {
        cig.push(3, diff);
        score = -(int64_t)go - diff * ge;
        i = diff;
    }
    int64_t ndiff = 0;
    for (; i < a; i++, j++) {
        const bool match = s1[i] == s2[j] && s1[i] < 4;
        cig.push(match ? 0 : 1, 1);
        ndiff += !match;
    }
    return score - ndiff * (int64_t)mm;
}

// Gotoh affine-gap global alignment with traceback (the WFA gap-affine
// role in smart_align's full-alignment branch, wfa.rs:289).  Maximizes
// match 0 / mismatch -mm / gap -(go + ge*len); no I<->D transitions.
static int64_t gotoh_global(const int8_t* s1, int64_t a, const int8_t* s2,
                            int64_t b, int32_t mm, int32_t go, int32_t ge,
                            CigarBuf& cig) {
    const int32_t NEG = INT32_MIN / 4;
    const int64_t W = b + 1;
    // One rolling row of scores per state + full traceback (2 bits/state).
    std::vector<int32_t> M(W), I(W), D(W), pM(W), pI(W), pD(W);
    // tb values: for M: 0=diag-from-M 1=diag-from-I 2=diag-from-D;
    // for I: 0=open(from M) 1=extend; for D likewise.
    std::vector<uint8_t> tb((size_t)(a + 1) * W, 0);
    pM[0] = 0;
    pI[0] = NEG;
    pD[0] = NEG;
    for (int64_t j = 1; j <= b; j++) {
        pM[j] = NEG;
        pD[j] = NEG;
        pI[j] = (int32_t)(-go - j * ge);
        tb[(size_t)j] = (j == 1 ? 0 : 1) << 2;
    }
    for (int64_t i = 1; i <= a; i++) {
        uint8_t* trow = tb.data() + (size_t)i * W;
        M[0] = NEG;
        I[0] = NEG;
        D[0] = (int32_t)(-go - i * ge);
        trow[0] = (i == 1 ? 0 : 1) << 4;
        for (int64_t j = 1; j <= b; j++) {
            const int32_t sub = (s1[i - 1] == s2[j - 1] && s1[i - 1] < 4)
                                    ? 0 : -mm;
            // M: diagonal from best of M/I/D.
            int32_t bestd = pM[j - 1];
            uint8_t tm = 0;
            if (pI[j - 1] > bestd) { bestd = pI[j - 1]; tm = 1; }
            if (pD[j - 1] > bestd) { bestd = pD[j - 1]; tm = 2; }
            M[j] = bestd + sub;
            // I: consumes query (seq2), horizontal.
            int32_t iopen = M[j - 1] - go - ge;
            int32_t iext = I[j - 1] - ge;
            uint8_t ti = iopen >= iext ? 0 : 1;
            I[j] = iopen >= iext ? iopen : iext;
            // D: consumes ref (seq1), vertical.
            int32_t dopen = pM[j] - go - ge;
            int32_t dext = pD[j] - ge;
            uint8_t td = dopen >= dext ? 0 : 1;
            D[j] = dopen >= dext ? dopen : dext;
            trow[j] = (uint8_t)(tm | (ti << 2) | (td << 4));
        }
        std::swap(M, pM);
        std::swap(I, pI);
        std::swap(D, pD);
    }
    // Traceback from the best end state.
    int state = 0;  // 0=M 1=I 2=D
    int32_t best = pM[b];
    if (pI[b] > best) { best = pI[b]; state = 1; }
    if (pD[b] > best) { best = pD[b]; state = 2; }
    std::vector<int32_t> rops, rlens;
    auto rpush = [&](int32_t op) {
        if (!rops.empty() && rops.back() == op)
            rlens.back()++;
        else {
            rops.push_back(op);
            rlens.push_back(1);
        }
    };
    int64_t i = a, j = b;
    while (i > 0 || j > 0) {
        const uint8_t t = tb[(size_t)i * W + j];
        if (state == 0) {
            rpush((s1[i - 1] == s2[j - 1] && s1[i - 1] < 4) ? 0 : 1);
            state = t & 3;
            i--;
            j--;
        } else if (state == 1) {
            rpush(2);
            state = ((t >> 2) & 3) ? 1 : 0;
            j--;
        } else {
            rpush(3);
            state = ((t >> 4) & 3) ? 2 : 0;
            i--;
        }
    }
    for (int64_t q = (int64_t)rops.size() - 1; q >= 0; q--)
        cig.push(rops[q], rlens[q]);
    return best;
}

// smart_align (wfa.rs:259-304): dispatch between pure gap / oversized gap
// (align_simple) / small equal-length mismatch run / full DP.
static int64_t smart_fill(const int8_t* s1, const int8_t* s2, int64_t i1,
                          int64_t i2, int64_t j1, int64_t j2, int64_t max_gap,
                          int32_t mm, int32_t go, int32_t ge, CigarBuf& cig) {
    const int64_t jump1 = i2 - i1, jump2 = j2 - j1;
    const int64_t safe_mm = (2 * (int64_t)go + 2 * ge) / mm;
    if (jump1 > 0 && jump2 > 0) {
        if (jump1 > max_gap || jump2 > max_gap)
            return align_simple(s1 + i1, jump1, s2 + j1, jump2, mm, go, ge,
                                cig);
        if (jump1 == jump2 && jump1 <= safe_mm) {
            int64_t ndiff = 0;
            for (int64_t t = 0; t < jump1; t++) {
                const bool match =
                    s1[i1 + t] == s2[j1 + t] && s1[i1 + t] < 4;
                cig.push(match ? 0 : 1, 1);
                ndiff += !match;
            }
            return -ndiff * (int64_t)mm;
        }
        return gotoh_global(s1 + i1, jump1, s2 + j1, jump2, mm, go, ge, cig);
    }
    if (jump1 > 0) {
        cig.push(3, jump1);
        return -(int64_t)go - jump1 * ge;
    }
    if (jump2 > 0) {
        cig.push(2, jump2);
        return -(int64_t)go - jump2 * ge;
    }
    return 0;
}

}  // namespace hapdist

extern "C" {

// ---------------------------------------------------------------------------
// 128-bit k-mer fingerprints, sorted by (hi, lo, pos).  Non-canonical exact
// k-mer stand-in (dist.rs precompute_kmers): two independent rolling
// polynomial hashes over 2^64; windows containing N are skipped.  Arbitrary
// k (25/51/101 in practice).  out_pos/out_lo/out_hi must hold n-k+1 entries;
// returns the number of valid windows.
// ---------------------------------------------------------------------------
int64_t kmer_fp_sorted(const int8_t* codes, int64_t n, int32_t k,
                       uint32_t* out_pos, uint64_t* out_lo, uint64_t* out_hi) {
    const int64_t m = n - k + 1;
    if (m <= 0) return 0;
    const uint64_t B1 = 0x9E3779B97F4A7C15ULL;  // odd constants
    const uint64_t B2 = 0xC2B2AE3D27D4EB4FULL;
    // B^(k-1) for removal of the outgoing base.
    uint64_t p1 = 1, p2 = 1;
    for (int32_t t = 0; t < k - 1; t++) { p1 *= B1; p2 *= B2; }
    uint64_t h1 = 0, h2 = 0;
    int64_t since_invalid = 0;
    std::vector<hapdist::FpEntry> entries;
    entries.reserve((size_t)m);
    for (int64_t i = 0; i < n; i++) {
        const int8_t c = codes[i];
        const uint64_t v = (uint64_t)(c & 3) + 1;
        if (i >= k) {
            const uint64_t old = (uint64_t)(codes[i - k] & 3) + 1;
            h1 -= old * p1;
            h2 -= old * p2;
        }
        h1 = h1 * B1 + v;
        h2 = h2 * B2 + v;
        since_invalid = (c < 4) ? since_invalid + 1 : 0;
        const int64_t pos = i - k + 1;
        if (pos >= 0 && since_invalid >= k)
            entries.push_back({h1, h2, (uint32_t)pos});
    }
    std::sort(entries.begin(), entries.end(),
              [](const hapdist::FpEntry& a, const hapdist::FpEntry& b) {
                  if (a.hi != b.hi) return a.hi < b.hi;
                  if (a.lo != b.lo) return a.lo < b.lo;
                  return a.pos < b.pos;
              });
    for (size_t t = 0; t < entries.size(); t++) {
        out_hi[t] = entries[t].hi;
        out_lo[t] = entries[t].lo;
        out_pos[t] = entries[t].pos;
    }
    return (int64_t)entries.size();
}

// ---------------------------------------------------------------------------
// Merge-join of two sorted fingerprint lists with exact window verification
// (dist.rs get_kmer_matches).  Output (p1, p2) pairs sorted by (p1, p2).
// Returns the match count, or -1 if cap would be exceeded.
// ---------------------------------------------------------------------------
int64_t kmer_match_join(const int8_t* codes1, const uint32_t* pos1,
                        const uint64_t* lo1, const uint64_t* hi1, int64_t c1,
                        const int8_t* codes2, const uint32_t* pos2,
                        const uint64_t* lo2, const uint64_t* hi2, int64_t c2,
                        int32_t k, uint32_t* out_p1, uint32_t* out_p2,
                        int64_t cap) {
    std::vector<std::pair<uint32_t, uint32_t>> matches;
    int64_t i = 0, j = 0;
    while (i < c1 && j < c2) {
        if (hi1[i] < hi2[j] || (hi1[i] == hi2[j] && lo1[i] < lo2[j]))
            i++;
        else if (hi1[i] > hi2[j] || lo1[i] > lo2[j])
            j++;
        else {
            int64_t ie = i, je = j;
            while (ie < c1 && hi1[ie] == hi1[i] && lo1[ie] == lo1[i]) ie++;
            while (je < c2 && hi2[je] == hi2[j] && lo2[je] == lo2[j]) je++;
            for (int64_t a = i; a < ie; a++)
                for (int64_t b = j; b < je; b++)
                    if (memcmp(codes1 + pos1[a], codes2 + pos2[b],
                               (size_t)k) == 0)
                        matches.push_back({pos1[a], pos2[b]});
            i = ie;
            j = je;
        }
    }
    std::sort(matches.begin(), matches.end());
    if ((int64_t)matches.size() > cap) return -1;
    for (size_t t = 0; t < matches.size(); t++) {
        out_p1[t] = matches[t].first;
        out_p2[t] = matches[t].second;
    }
    return (int64_t)matches.size();
}

// ---------------------------------------------------------------------------
// Chained global alignment of seq1 (ref/target) vs seq2 (query), the
// counterpart of dist.rs align():184-243: LCSk++ over the exact k-mer
// matches, then walk the chain pushing '=' runs for anchors and smart-fill
// for inter-anchor gaps.  Covers both sequences end-to-end.  Returns n_ops
// (run-length CIGAR in out_ops/out_lens) or -1 if max_ops is too small;
// *out_score receives the WFA-convention score (match 0, mismatch -mm,
// gap -(go+ge*len)).
// ---------------------------------------------------------------------------
int64_t chain_align(const int8_t* seq1, int64_t n1, const int8_t* seq2,
                    int64_t n2, const uint32_t* ap1, const uint32_t* ap2,
                    int64_t n_anchors, int32_t k, int32_t max_gap,
                    int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                    int32_t* out_ops, int32_t* out_lens, int64_t max_ops,
                    int64_t* out_score) {
    std::vector<int64_t> path;
    hapdist::lcskpp(ap1, ap2, n_anchors, (uint32_t)k, path);
    hapdist::CigarBuf cig;
    int64_t score = 0;
    int64_t i1 = 0, j1 = 0, curr_match = 0;
    for (const int64_t ix : path) {
        const int64_t i2 = ap1[ix], j2 = ap2[ix];
        if (i1 > i2) {
            // Overlapping continuation anchor: extend the match by one base.
            curr_match++;
            i1++;
            j1++;
            continue;
        }
        if (curr_match > 0) {
            cig.push(0, curr_match);
            curr_match = 0;
        }
        score += hapdist::smart_fill(seq1, seq2, i1, i2, j1, j2, max_gap,
                                     mismatch, gap_open, gap_extend, cig);
        curr_match = k;
        i1 = i2 + k;
        j1 = j2 + k;
    }
    if (curr_match > 0) cig.push(0, curr_match);
    score += hapdist::smart_fill(seq1, seq2, i1, n1, j1, n2, max_gap,
                                 mismatch, gap_open, gap_extend, cig);
    if ((int64_t)cig.ops.size() > max_ops) return -1;
    for (size_t t = 0; t < cig.ops.size(); t++) {
        out_ops[t] = cig.ops[t];
        out_lens[t] = cig.lens[t];
    }
    *out_score = score;
    return (int64_t)cig.ops.size();
}

}  // extern "C"
