// htstpu — native host kernels for the TPU HTS framework.
//
// The reference (samtools/htslib) is single-process C with a pthread worker
// pool fanning out per-block jobs (bgzf.c:1598, thread_pool.c:518).  Here the
// host-side unit is a *batch*: the caller hands us every block of a byte
// range at once and we process them in parallel with a small thread team.
// Ordering is implicit in the batch index, so no serial-number queueing is
// needed.
//
// Exposed via a C ABI for ctypes.  All functions return 0 on success or a
// negative error code.

#include <dlfcn.h>
#include <libdeflate.h>
#include <lzma.h>
#include <sys/mman.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#include <cstdlib>
#include <cstdio>
#include <cctype>
#include <algorithm>
#include <string>
#include <unordered_map>

namespace {

constexpr int kBlockHeader = 18;
constexpr int kBlockFooter = 8;
constexpr size_t kMaxBlock = 0x10000;

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? static_cast<int>(n) : 2;
}

// Per-thread cached libdeflate compressor: allocation at level>=6 builds
// large match tables, and paying it per 64KiB block dominated the batch
// deflate profile (~5x the compress itself).  htslib keeps one zlib
// stream per bgzf job for the same reason (bgzf.c:561).
struct TlCompressor {
  struct libdeflate_compressor* c = nullptr;
  int level = -1;
  ~TlCompressor() {
    if (c) libdeflate_free_compressor(c);
  }
  struct libdeflate_compressor* get(int lvl) {
    if (!c || level != lvl) {
      if (c) libdeflate_free_compressor(c);
      c = libdeflate_alloc_compressor(lvl);
      level = lvl;
    }
    return c;
  }
};

struct libdeflate_compressor* tl_compressor(int level) {
  thread_local TlCompressor tl;
  return tl.get(level);
}

// Coarse phase accounting (ns) for the fused CRAM path — 3 clock reads
// per slice, negligible; read back via htstpu_prof_get for tuning.
inline uint64_t prof_now() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}
std::atomic<uint64_t> g_prof[8];

}  // namespace

extern "C" {
uint64_t htstpu_prof_get(int i) { return g_prof[i & 7].load(); }
void htstpu_prof_reset() { for (auto& a : g_prof) a.store(0); }
}

namespace {

// Parse one BGZF member header; returns total member size or -1.
int64_t parse_bsize(const uint8_t* p, size_t avail) {
  if (avail < kBlockHeader) return -1;
  if (p[0] != 0x1f || p[1] != 0x8b || !(p[3] & 4)) return -1;
  unsigned xlen = p[10] | (p[11] << 8);
  size_t pos = 12, end = 12 + xlen;
  while (pos + 4 <= end && pos + 4 <= avail) {
    uint8_t si1 = p[pos], si2 = p[pos + 1];
    unsigned slen = p[pos + 2] | (p[pos + 3] << 8);
    if (si1 == 'B' && si2 == 'C' && slen == 2) {
      if (pos + 6 > avail) return -1;
      unsigned bsize = p[pos + 4] | (p[pos + 5] << 8);
      return (int64_t)bsize + 1;
    }
    pos += 4 + slen;
  }
  return -1;
}

template <typename F>
void parallel_for(int64_t n, int nthreads, F&& fn) {
  if (n <= 0) return;
  if (nthreads <= 1 || n == 1) {
    for (int64_t i = 0; i < n; i++) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n) return;
      fn(i);
    }
  };
  std::vector<std::thread> team;
  int t = std::min<int64_t>(nthreads, n);
  team.reserve(t - 1);
  for (int i = 1; i < t; i++) team.emplace_back(worker);
  worker();
  for (auto& th : team) th.join();
}

}  // namespace

extern "C" {

// Scan BGZF members in [data, data+len).  Writes up to cap entries of
// (coffset, csize, usize).  Returns the number of blocks, or
// -2 truncated / -3 bad magic / -4 overflow(cap).
int64_t htstpu_bgzf_scan(const uint8_t* data, uint64_t len, uint64_t cap,
                         uint64_t* coffsets, uint32_t* csizes,
                         uint32_t* usizes) {
  uint64_t pos = 0;
  int64_t n = 0;
  while (pos + kBlockHeader <= len) {
    int64_t total = parse_bsize(data + pos, len - pos);
    if (total < 0) return -3;
    if (pos + (uint64_t)total > len) return -2;
    if ((uint64_t)n >= cap) return -4;
    uint32_t isize;
    std::memcpy(&isize, data + pos + total - 4, 4);
    coffsets[n] = pos;
    csizes[n] = (uint32_t)total;
    usizes[n] = isize;
    n++;
    pos += total;
  }
  if (pos != len) return -2;
  return n;
}

// Inflate n BGZF members in parallel into `out` at out_offsets[i]
// (the caller computes out_offsets as the exclusive prefix sum of usizes).
// Returns 0, or -(1000+i) for a failure in block i.
int64_t htstpu_inflate_batch(const uint8_t* data, uint64_t len, int64_t n,
                             const uint64_t* coffsets, const uint32_t* csizes,
                             const uint32_t* usizes,
                             const uint64_t* out_offsets, uint8_t* out,
                             int verify_crc, int nthreads) {
  if (nthreads <= 0) nthreads = hardware_threads();
  std::atomic<int64_t> err(0);
  std::atomic<int64_t> next(0);
  // one decompressor per worker, work-stolen block at a time
  auto worker = [&]() {
    struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    for (;;) {
      int64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= n || err.load(std::memory_order_relaxed)) break;
      const uint8_t* p = data + coffsets[i];
      uint32_t csize = csizes[i], usize = usizes[i];
      // payload bounds: header (with extras) .. footer
      unsigned xlen = p[10] | (p[11] << 8);
      if (12u + xlen + kBlockFooter > csize) {
        err.store(-(1000 + i), std::memory_order_relaxed);
        continue;
      }
      const uint8_t* payload = p + 12 + xlen;
      size_t paylen = csize - (12 + xlen) - kBlockFooter;
      size_t actual = 0;
      enum libdeflate_result r = libdeflate_deflate_decompress(
          d, payload, paylen, out + out_offsets[i], usize, &actual);
      if (r != LIBDEFLATE_SUCCESS || actual != usize) {
        err.store(-(1000 + i), std::memory_order_relaxed);
      } else if (verify_crc) {
        uint32_t want;
        std::memcpy(&want, p + csize - 8, 4);
        uint32_t got = libdeflate_crc32(0, out + out_offsets[i], usize);
        if (got != want) err.store(-(1000 + i), std::memory_order_relaxed);
      }
    }
    libdeflate_free_decompressor(d);
  };
  std::vector<std::thread> team;
  int t = std::min<int64_t>(nthreads, n);
  for (int i = 1; i < t; i++) team.emplace_back(worker);
  worker();
  for (auto& th : team) th.join();
  return err.load();
}

// Compress n chunks (<=0xff00 bytes each) of `data` at in_offsets/in_lens
// into complete BGZF members written at out + i*kMaxBlock; out_lens[i]
// receives each member's size.  level: 1..12 libdeflate, 0 = stored.
int64_t htstpu_deflate_batch(const uint8_t* data, int64_t n,
                             const uint64_t* in_offsets,
                             const uint32_t* in_lens, int level, uint8_t* out,
                             uint32_t* out_lens, int nthreads) {
  if (nthreads <= 0) nthreads = hardware_threads();
  if (level < 0) level = 6;
  std::atomic<int64_t> err(0);
  parallel_for(n, nthreads, [&](int64_t i) {
    if (err.load(std::memory_order_relaxed)) return;
    const uint8_t* in = data + in_offsets[i];
    uint32_t ilen = in_lens[i];
    uint8_t* dst = out + (uint64_t)i * kMaxBlock;
    struct libdeflate_compressor* c = tl_compressor(level == 0 ? 0 : level);
    size_t csize =
        libdeflate_deflate_compress(c, in, ilen, dst + kBlockHeader,
                                    kMaxBlock - kBlockHeader - kBlockFooter);
    if (csize == 0) {
      err.store(-(2000 + i), std::memory_order_relaxed);
      return;
    }
    uint32_t total = (uint32_t)(csize + kBlockHeader + kBlockFooter);
    // header (bgzf.c:70-90 layout)
    static const uint8_t magic[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                                      0,    0xff, 0x06, 0x00, 'B', 'C', 2, 0};
    std::memcpy(dst, magic, 16);
    uint16_t bsize = (uint16_t)(total - 1);
    std::memcpy(dst + 16, &bsize, 2);
    uint32_t crc = libdeflate_crc32(0, in, ilen);
    std::memcpy(dst + kBlockHeader + csize, &crc, 4);
    std::memcpy(dst + kBlockHeader + csize + 4, &ilen, 4);
    out_lens[i] = total;
  });
  return err.load();
}

// Walk BAM records over an uncompressed byte range starting at `start`
// (i.e. after the header): each record is u32 block_size + block_size
// bytes (sam.c:784 bam_read1 framing).  Writes record offsets (relative to
// data) and lengths (incl. the 4-byte size field).  Returns count or
// -2 truncated / -4 overflow.
int64_t htstpu_bam_scan(const uint8_t* data, uint64_t len, uint64_t start,
                        uint64_t cap, uint64_t* offsets, uint32_t* sizes) {
  uint64_t pos = start;
  int64_t n = 0;
  while (pos + 4 <= len) {
    uint32_t bsz;
    std::memcpy(&bsz, data + pos, 4);
    if (pos + 4 + bsz > len) return -2;
    if (bsz < 32) return -3;
    if ((uint64_t)n >= cap) return -4;
    offsets[n] = pos;
    sizes[n] = bsz + 4;
    n++;
    pos += 4 + (uint64_t)bsz;
  }
  if (pos != len) return -2;
  return n;
}

uint32_t htstpu_crc32(uint32_t crc, const uint8_t* data, uint64_t len) {
  return libdeflate_crc32(crc, data, len);
}

int htstpu_version() { return 1; }

}  // extern "C"

// ---------------------------------------------------------------------------
// BAM -> SAM text formatting (the sam_format_worker equivalent, batch form)
// ---------------------------------------------------------------------------

namespace {

const char kNt16[] = "=ACMGRSVTWYHKDBN";
const char kCigChar[] = "MIDNSHP=XB??????";

#if defined(__SSSE3__)
#include <immintrin.h>
// Vectorised 4-bit-packed -> ASCII base expansion (the reference's SSSE3
// nibble2base, simd.c:121-180, rebuilt): each 16 packed input bytes become
// 32 output bases via two pshufb table lookups + interleave.  `dst` must
// have >= 2*ceil(n/16)*16 bytes of headroom (caller over-reserves).
inline void nibble2base_simd(const uint8_t* src, uint8_t* dst, int64_t n_packed) {
  int64_t i = 0;
#if defined(__AVX2__)
  // 32 packed bytes -> 64 bases per iteration (vpshufb runs per 128-bit
  // lane, so unpack lo/hi stay lane-local and order is preserved by
  // working on each 16-byte half's own output span)
  const __m256i tbl2 = _mm256_broadcastsi128_si256(
      _mm_loadu_si128((const __m128i*)kNt16));
  const __m256i lo_mask2 = _mm256_set1_epi8(0x0F);
  for (; i + 32 <= n_packed; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(src + i));
    __m256i lo = _mm256_and_si256(v, lo_mask2);
    __m256i hi = _mm256_and_si256(_mm256_srli_epi16(v, 4), lo_mask2);
    __m256i lo_c = _mm256_shuffle_epi8(tbl2, lo);
    __m256i hi_c = _mm256_shuffle_epi8(tbl2, hi);
    __m256i a = _mm256_unpacklo_epi8(hi_c, lo_c);   // lanes: [0:8), [16:24)
    __m256i b = _mm256_unpackhi_epi8(hi_c, lo_c);   // lanes: [8:16), [24:32)
    _mm_storeu_si128((__m128i*)(dst + 2 * i),
                     _mm256_castsi256_si128(a));
    _mm_storeu_si128((__m128i*)(dst + 2 * i + 16),
                     _mm256_castsi256_si128(b));
    _mm_storeu_si128((__m128i*)(dst + 2 * i + 32),
                     _mm256_extracti128_si256(a, 1));
    _mm_storeu_si128((__m128i*)(dst + 2 * i + 48),
                     _mm256_extracti128_si256(b, 1));
  }
#endif
  const __m128i tbl = _mm_loadu_si128((const __m128i*)kNt16);
  const __m128i lo_mask = _mm_set1_epi8(0x0F);
  for (; i + 16 <= n_packed; i += 16) {
    __m128i v = _mm_loadu_si128((const __m128i*)(src + i));
    __m128i lo = _mm_and_si128(v, lo_mask);
    __m128i hi = _mm_and_si128(_mm_srli_epi16(v, 4), lo_mask);
    __m128i lo_c = _mm_shuffle_epi8(tbl, lo);
    __m128i hi_c = _mm_shuffle_epi8(tbl, hi);
    // base order within a packed byte is (hi, lo)
    _mm_storeu_si128((__m128i*)(dst + 2 * i), _mm_unpacklo_epi8(hi_c, lo_c));
    _mm_storeu_si128((__m128i*)(dst + 2 * i + 16), _mm_unpackhi_epi8(hi_c, lo_c));
  }
  for (; i < n_packed; i++) {
    dst[2 * i] = kNt16[src[i] >> 4];
    dst[2 * i + 1] = kNt16[src[i] & 0xF];
  }
}
#endif

// 256-entry packed-byte -> two-ASCII-base table (portable analogue of the
// reference's SSSE3/NEON nibble2base, simd.c:121-229)
struct Nt16x2 {
  uint16_t t[256];
  Nt16x2() {
    for (int b = 0; b < 256; b++) {
      uint16_t v;
      char two[2] = {kNt16[b >> 4], kNt16[b & 0xF]};
      memcpy(&v, two, 2);
      t[b] = v;
    }
  }
};
const Nt16x2 kNt16x2;

struct NameTable {
  const uint8_t* buf;
  const uint64_t* offs;
  const uint32_t* lens;
  int32_t n_ref;
  uint32_t max_name = 0;   // cached max_len() for per-record bounds
  uint32_t max_len() const {
    uint32_t m = 1;
    for (int32_t i = 0; i < n_ref; i++) m = std::max(m, lens[i]);
    return m;
  }
};

// Worst-case SAM text bytes for `span` BAM record bytes: the densest
// expansion is a B:c aux array (1 byte -> ",-128" = 5 chars); seq nibbles
// are 2x; CIGAR u32s up to 2.5x; everything else <=5x.  Reference names
// come from the name table (not the record), so add 2*max_name per record
// (RNAME + RNEXT) at the minimum record pitch of 36 bytes.
inline uint64_t sam_out_bound(uint64_t span, uint32_t max_name) {
  return span * 6 + (span / 36 + 1) * (2ull * max_name + 16) + (1 << 20);
}

class Buf {
 public:
  Buf() : data_(nullptr), len_(0), cap_(0) {}
  ~Buf() { free(data_); }
  void reserve(size_t need) {
    if (len_ + need <= cap_) return;
    size_t ncap = cap_ ? cap_ * 2 : 1 << 20;
    while (ncap < len_ + need) ncap *= 2;
    data_ = (uint8_t*)realloc(data_, ncap);
    cap_ = ncap;
  }
  inline void put(const void* p, size_t n) {
    reserve(n);
    memcpy(data_ + len_, p, n);
    len_ += n;
  }
  inline void putc(char c) {
    reserve(1);
    data_[len_++] = c;
  }
  inline void put_fill(char c, size_t n) {
    reserve(n);
    memset(data_ + len_, (unsigned char)c, n);
    len_ += n;
  }
  // two digits at a time via a 100-entry pair table (kputll-style,
  // reference NEWS:461-462 credits this with +5% BAM->SAM)
  static const char* digit_pairs() {
    static const char p[] =
        "00010203040506070809101112131415161718192021222324"
        "25262728293031323334353637383940414243444546474849"
        "50515253545556575859606162636465666768697071727374"
        "75767778798081828384858687888990919293949596979899";
    return p;
  }
  inline void put_i64(int64_t v) {
    reserve(21);
    if (v < 0) { data_[len_++] = '-'; }
    uint64_t x = v < 0 ? (uint64_t)(-v) : (uint64_t)v;
    const char* dp = digit_pairs();
    char tmp[20];
    int i = 20;
    while (x >= 100) {
      uint64_t r = x % 100;
      x /= 100;
      i -= 2;
      memcpy(tmp + i, dp + 2 * r, 2);
    }
    if (x >= 10) {
      i -= 2;
      memcpy(tmp + i, dp + 2 * x, 2);
    } else {
      tmp[--i] = '0' + (char)x;
    }
    memcpy(data_ + len_, tmp + i, 20 - i);
    len_ += 20 - i;
  }
  // unchecked writes: caller must have reserve()d the worst case.
  // write_i64 is the raw-pointer put_i64 used by both.
  static inline uint8_t* write_i64(uint8_t* w, int64_t v) {
    if (v < 0) *w++ = '-';
    uint64_t x = v < 0 ? (uint64_t)(-v) : (uint64_t)v;
    // 1-2 digit fast path: the bulk of VCF/SAM numeric values
    if (x < 10) { *w++ = (char)('0' + x); return w; }
    const char* dp = digit_pairs();
    if (x < 100) { memcpy(w, dp + 2 * x, 2); return w + 2; }
    char tmp[20];
    int i = 20;
    while (x >= 100) {
      uint64_t r = x % 100;
      x /= 100;
      i -= 2;
      memcpy(tmp + i, dp + 2 * r, 2);
    }
    if (x >= 10) {
      i -= 2;
      memcpy(tmp + i, dp + 2 * x, 2);
    } else {
      tmp[--i] = '0' + (char)x;
    }
    memcpy(w, tmp + i, 20 - i);
    return w + (20 - i);
  }
  inline void putc_u(char c) { data_[len_++] = c; }
  inline void put_u(const void* p, size_t n) {
    memcpy(data_ + len_, p, n);
    len_ += n;
  }
  inline void put_i64_u(int64_t v) {
    len_ = (size_t)(write_i64(data_ + len_, v) - data_);
  }
  uint8_t* data() { return data_; }
  uint8_t* end_ptr() { return data_ + len_; }
  size_t len() const { return len_; }
  inline void bump(size_t n) { len_ += n; }
  inline void clear() { len_ = 0; }
  inline void set_len(size_t n) { len_ = n; }

 private:
  uint8_t* data_;
  size_t len_, cap_;
};

// Big scratch allocations stay on malloc: the Python side tunes the glibc
// arena (M_MMAP_THRESHOLD/M_TRIM_THRESHOLD) so repeated pipeline calls
// reuse already-faulted pages instead of paying ~50k page faults per call
// the way a fresh mmap would.  Over-asking is fine — untouched tail pages
// are never committed.
uint8_t* big_alloc(size_t cap) { return (uint8_t*)malloc(cap); }
void big_free(uint8_t* p, size_t) { free(p); }

// In-order batch committer: format workers produce SAM text for batch i in
// a reusable per-thread scratch Buf, then append it to the single output
// buffer strictly in batch order (the batch analogue of the reference's
// serial-number-ordered result queue, thread_pool_internal.h:74).  The
// turn-holder only *reserves* its byte range — a couple of atomic stores —
// and the memcpy itself runs outside the turn, so commit copies from many
// workers proceed in parallel and the serial section stays O(1) per batch
// no matter how wide the thread team is.  The backing store is a single
// NORESERVE mmap sized to a worst-case expansion bound, so no realloc can
// ever move it under a concurrent copier.
struct OrderedSink {
  uint8_t* out = nullptr;
  uint64_t cap = 0;
  std::atomic<uint64_t> bytes{0};      // reserved length
  std::atomic<int64_t> turn{0};        // next batch index allowed in
  bool init(uint64_t virtual_cap) {
    cap = virtual_cap ? virtual_cap : 4096;
    out = big_alloc(cap);
    return out != nullptr;
  }
  // Returns false if err was raised elsewhere or the bound was exceeded.
  bool commit(int64_t bi, const uint8_t* data, uint64_t len,
              std::atomic<int64_t>& err) {
    while (turn.load(std::memory_order_acquire) != bi) {
      if (err.load(std::memory_order_relaxed)) return false;
      std::this_thread::yield();
    }
    uint64_t off = bytes.load(std::memory_order_relaxed);
    if (off + len > cap) {
      err.store(-5, std::memory_order_relaxed);
      turn.store(bi + 1, std::memory_order_release);
      return false;
    }
    bytes.store(off + len, std::memory_order_relaxed);
    turn.store(bi + 1, std::memory_order_release);
    memcpy(out + off, data, len);  // parallel with other committers
    return true;
  }
  // A claimed batch with no records must still pass its turn along.
  void skip(int64_t bi, std::atomic<int64_t>& err) {
    while (turn.load(std::memory_order_acquire) != bi) {
      if (err.load(std::memory_order_relaxed)) return;
      std::this_thread::yield();
    }
    turn.store(bi + 1, std::memory_order_release);
  }
  void abandon() { big_free(out, cap); out = nullptr; }
  // Hand ownership to the caller (htstpu_buf_free releases it).
  uint8_t* release() {
    uint8_t* p = out;
    out = nullptr;
    return p;
  }
};

inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// --- speculative parallel BAM record-boundary scan --------------------------
//
// Record framing (u32 block_size + payload) has no sync markers, so a scan
// is inherently sequential — unless we guess.  Each worker re-synchronises
// at its segment boundary by testing candidate offsets against the record
// invariants (bam_read1's validation set, sam.c:824-828) chained across
// several successive records; a serial stitch pass then *verifies* every
// segment's guess against the previous segment's carry, re-scanning any
// segment whose guess was wrong.  Correctness never depends on the
// heuristic — a bad sync only costs a serial rescan of that one segment.

// Is `p` a plausible record start?  (bounds-checked against [0, U))
inline bool plausible_record(const uint8_t* u, uint64_t U, uint64_t p,
                             int32_t n_ref) {
  if (p + 4 > U) return false;
  uint32_t bsz = rd_u32(u + p);
  if (bsz < 32 || p + 4 + (uint64_t)bsz > U) return false;
  const uint8_t* r = u + p + 4;
  int32_t tid = (int32_t)rd_u32(r + 0);
  int32_t pos = (int32_t)rd_u32(r + 4);
  uint8_t l_qname = r[8];
  uint16_t n_cigar = rd_u16(r + 12);
  int32_t l_qseq = (int32_t)rd_u32(r + 16);
  int32_t mtid = (int32_t)rd_u32(r + 20);
  int32_t mpos = (int32_t)rd_u32(r + 24);
  if (tid < -1 || tid >= n_ref) return false;
  if (mtid < -1 || mtid >= n_ref) return false;
  if (pos < -1 || mpos < -1) return false;
  if (l_qname == 0 || l_qseq < 0) return false;
  uint64_t need = 32ull + l_qname + 4ull * n_cigar + (l_qseq + 1) / 2 + l_qseq;
  if (need > bsz) return false;
  return true;
}

// Chain-validate: `p` must look like a record AND its next `depth`
// successors must too (or the stream must end exactly).
inline bool validate_chain(const uint8_t* u, uint64_t U, uint64_t p,
                           int32_t n_ref, int depth) {
  for (int d = 0; d <= depth; d++) {
    if (p == U) return true;
    if (!plausible_record(u, U, p, n_ref)) return false;
    p += 4 + (uint64_t)rd_u32(u + p);
  }
  return true;
}

// Parallel speculative scan of [start, U) into `offs` (cap entries).
// Returns record count, or -2 truncated / -3 bad record.
int64_t spec_scan_records(const uint8_t* u, uint64_t U, uint64_t start,
                          int32_t n_ref, uint64_t* offs, uint64_t cap,
                          int nthreads) {
  const uint64_t span = U - start;
  const uint64_t kSeg = 4u << 20;
  int64_t nseg = (int64_t)((span + kSeg - 1) / kSeg);
  if (nseg < 1) nseg = 1;
  struct Seg {
    uint64_t spec_start = UINT64_MAX;  // first record offset >= seg begin
    uint64_t carry = 0;                // first record offset >= seg end
    std::vector<uint64_t> offs;        // record offsets within [begin, end)
    bool bad = false;                  // scan hit an invariant violation
  };
  std::vector<Seg> segs(nseg);
  // hop-scan from a known-good record start `p` until >= lim; appends to v.
  // Returns 0 ok, -2 truncated, -3 bad record.
  auto hop = [&](uint64_t p, uint64_t lim, std::vector<uint64_t>& v,
                 uint64_t* carry) -> int {
    while (p < lim) {
      if (p + 4 > U) return -2;
      uint32_t bsz = rd_u32(u + p);
      if (bsz < 32) return -3;
      if (p + 4 + (uint64_t)bsz > U) return -2;
      v.push_back(p);
      __builtin_prefetch(u + p + 1024);
      p += 4 + (uint64_t)bsz;
    }
    *carry = p;
    return 0;
  };
  parallel_for(nseg, nthreads, [&](int64_t k) {
    Seg& s = segs[k];
    uint64_t beg = start + (uint64_t)k * kSeg;
    uint64_t end = std::min<uint64_t>(U, beg + kSeg);
    uint64_t p = k == 0 ? start : UINT64_MAX;
    if (k > 0) {
      // sync: first chain-valid offset at/after beg
      for (uint64_t c = beg; c < end; c++) {
        if (validate_chain(u, U, c, n_ref, 4)) { p = c; break; }
      }
      if (p == UINT64_MAX) return;  // no sync: stitch rescans serially
    }
    s.spec_start = p;
    s.offs.reserve((end - p) / 64 + 4);
    if (hop(p, end, s.offs, &s.carry) != 0) s.bad = true;
  });
  // serial stitch: verify each segment's guess against the running carry
  int64_t n = 0;
  uint64_t expected = start;
  for (int64_t k = 0; k < nseg; k++) {
    Seg& s = segs[k];
    uint64_t end = std::min<uint64_t>(U, start + (uint64_t)(k + 1) * kSeg);
    if (s.spec_start == expected && !s.bad) {
      if ((uint64_t)n + s.offs.size() > cap) return -4;
      memcpy(offs + n, s.offs.data(), s.offs.size() * sizeof(uint64_t));
      n += (int64_t)s.offs.size();
      expected = s.carry;
    } else {
      // wrong guess (or unsynced/bad segment): rescan it serially
      std::vector<uint64_t> v;
      uint64_t carry = expected;
      if (expected < end) {
        int rc = hop(expected, end, v, &carry);
        if (rc != 0) return rc;
      }
      if ((uint64_t)n + v.size() > cap) return -4;
      memcpy(offs + n, v.data(), v.size() * sizeof(uint64_t));
      n += (int64_t)v.size();
      expected = carry;
    }
  }
  if (expected != U) return -2;
  return n;
}

// Format one record's aux blob; returns 0 ok, -1 corrupt.
// skips a CG tag at `skip_off` (relative to aux start; -1 = none).
int format_aux(const uint8_t* aux, int64_t alen, int64_t skip_off,
               int64_t skip_len, Buf* out) {
  int64_t s = 0;
  char tmp[64];
  while (s + 3 <= alen) {
    if (s == skip_off) { s += skip_len; continue; }
    const uint8_t* tag = aux + s;
    char t = (char)aux[s + 2];
    int64_t p = s + 3;
    out->putc_u('\t');
    out->put_u(tag, 2);
    switch (t) {
      case 'C': if (p+1>alen) return -1;
        out->put_u(":i:", 3); out->put_i64_u(aux[p]); p += 1; break;
      case 'c': if (p+1>alen) return -1;
        out->put_u(":i:", 3); out->put_i64_u((int8_t)aux[p]); p += 1; break;
      case 'S': if (p+2>alen) return -1;
        out->put_u(":i:", 3); out->put_i64_u(rd_u16(aux+p)); p += 2; break;
      case 's': if (p+2>alen) return -1;
        out->put_u(":i:", 3); out->put_i64_u((int16_t)rd_u16(aux+p)); p += 2; break;
      case 'I': if (p+4>alen) return -1;
        out->put_u(":i:", 3); out->put_i64_u(rd_u32(aux+p)); p += 4; break;
      case 'i': if (p+4>alen) return -1;
        out->put_u(":i:", 3); out->put_i64_u((int32_t)rd_u32(aux+p)); p += 4; break;
      case 'A': if (p+1>alen) return -1;
        out->put_u(":A:", 3); out->putc_u((char)aux[p]); p += 1; break;
      case 'f': {
        if (p+4>alen) return -1;
        float f;
        memcpy(&f, aux + p, 4);
        int n = snprintf(tmp, sizeof tmp, ":f:%g", (double)f);
        out->put_u(tmp, n);
        p += 4;
        break;
      }
      case 'd': {
        if (p+8>alen) return -1;
        double d;
        memcpy(&d, aux + p, 8);
        int n = snprintf(tmp, sizeof tmp, ":d:%g", d);
        out->put_u(tmp, n);
        p += 8;
        break;
      }
      case 'Z': case 'H': {
        out->putc_u(':'); out->putc_u(t); out->putc_u(':');
        int64_t e = p;
        while (e < alen && aux[e]) e++;
        if (e >= alen) return -1;
        out->put_u(aux + p, e - p);
        p = e + 1;
        break;
      }
      case 'B': {
        if (p + 5 > alen) return -1;
        char sub = (char)aux[p];
        uint32_t cnt = rd_u32(aux + p + 1);
        p += 5;
        out->put_u(":B:", 3);
        out->putc_u(sub);
        switch (sub) {
          case 'c': if (p+(int64_t)cnt>alen) return -1;
            for (uint32_t i = 0; i < cnt; i++) { out->putc_u(','); out->put_i64_u((int8_t)aux[p+i]); }
            p += cnt; break;
          case 'C': if (p+(int64_t)cnt>alen) return -1;
            for (uint32_t i = 0; i < cnt; i++) { out->putc_u(','); out->put_i64_u(aux[p+i]); }
            p += cnt; break;
          case 's': if (p+2LL*cnt>alen) return -1;
            for (uint32_t i = 0; i < cnt; i++) { out->putc_u(','); out->put_i64_u((int16_t)rd_u16(aux+p+2*i)); }
            p += 2LL*cnt; break;
          case 'S': if (p+2LL*cnt>alen) return -1;
            for (uint32_t i = 0; i < cnt; i++) { out->putc_u(','); out->put_i64_u(rd_u16(aux+p+2*i)); }
            p += 2LL*cnt; break;
          case 'i': if (p+4LL*cnt>alen) return -1;
            for (uint32_t i = 0; i < cnt; i++) { out->putc_u(','); out->put_i64_u((int32_t)rd_u32(aux+p+4*i)); }
            p += 4LL*cnt; break;
          case 'I': if (p+4LL*cnt>alen) return -1;
            for (uint32_t i = 0; i < cnt; i++) { out->putc_u(','); out->put_i64_u(rd_u32(aux+p+4*i)); }
            p += 4LL*cnt; break;
          case 'f': if (p+4LL*cnt>alen) return -1;
            for (uint32_t i = 0; i < cnt; i++) {
              float f; memcpy(&f, aux+p+4*i, 4);
              int n = snprintf(tmp, sizeof tmp, ",%g", (double)f);
              out->put_u(tmp, n);
            }
            p += 4LL*cnt; break;
          default: return -1;
        }
        break;
      }
      default:
        return -1;
    }
    s = p;
  }
  return s == alen ? 0 : -1;
}

// Format one BAM record (payload after block_size) as one SAM line + \n.
int format_record(const uint8_t* rec, uint32_t size, const NameTable& nt,
                  Buf* out) {
  if (size < 32) return -1;
  // one worst-case reservation, then raw unchecked writes throughout
  // (sam_out_bound reasoning: densest expansion is a B:c aux byte ->
  // ",-128" = 5 chars; nibbles 2x; CIGAR u32 <= 11 chars; +32 B SIMD
  // store slack for the sequence lane)
  out->reserve(6ull * size + 2ull * nt.max_name + 96);
  int32_t tid = (int32_t)rd_u32(rec + 0);
  int32_t pos = (int32_t)rd_u32(rec + 4);
  uint8_t l_qname = rec[8];
  uint8_t mapq = rec[9];
  uint16_t n_cigar = rd_u16(rec + 12);
  uint16_t flag = rd_u16(rec + 14);
  int32_t l_qseq = (int32_t)rd_u32(rec + 16);
  int32_t mtid = (int32_t)rd_u32(rec + 20);
  int32_t mpos = (int32_t)rd_u32(rec + 24);
  int32_t tlen = (int32_t)rd_u32(rec + 28);
  const uint8_t* qname = rec + 32;
  const uint8_t* cig = qname + l_qname;
  const uint8_t* seq = cig + 4ull * n_cigar;
  const uint8_t* qual = seq + (l_qseq + 1) / 2;
  const uint8_t* aux = qual + l_qseq;
  const uint8_t* end = rec + size;
  if (l_qseq < 0 || aux > end || l_qname == 0) return -1;

  // CG long-cigar escape (bam_tag2cigar, sam.c:680)
  const uint8_t* real_cig = cig;
  uint32_t real_n_cigar = n_cigar;
  int64_t cg_skip_off = -1, cg_skip_len = 0;
  if (n_cigar > 0 && tid >= 0 && pos >= 0) {
    uint32_t c0 = rd_u32(cig);
    if (c0 == (((uint32_t)l_qseq << 4) | 4)) {
      // look for CG:B,I in aux
      int64_t alen = end - aux;
      int64_t s = 0;
      while (s + 3 <= alen) {
        char t = (char)aux[s + 2];
        int64_t p = s + 3;
        int64_t sz = 0;
        switch (t) {
          case 'A': case 'c': case 'C': sz = 1; break;
          case 's': case 'S': sz = 2; break;
          case 'i': case 'I': case 'f': sz = 4; break;
          case 'd': sz = 8; break;
          case 'Z': case 'H': {
            int64_t e = p;
            while (e < alen && aux[e]) e++;
            sz = e - p + 1;
            break;
          }
          case 'B': {
            if (p + 5 > alen) { s = alen + 1; continue; }
            char sub = (char)aux[p];
            uint32_t cnt = rd_u32(aux + p + 1);
            int64_t es = (sub=='c'||sub=='C'||sub=='A') ? 1 :
                         (sub=='s'||sub=='S') ? 2 :
                         (sub=='i'||sub=='I'||sub=='f') ? 4 : 0;
            if (!es) { s = alen + 1; continue; }
            sz = 5 + es * (int64_t)cnt;
            break;
          }
          default: s = alen + 1; continue;
        }
        if (aux[s]=='C' && aux[s+1]=='G' && t=='B' && p+1<=alen &&
            (aux[p]=='I' || aux[p]=='i')) {
          uint32_t cnt = rd_u32(aux + p + 1);
          if (cnt >= n_cigar && cnt < (1u<<29) && p + 5 + 4LL*cnt <= alen) {
            real_cig = aux + p + 5;
            real_n_cigar = cnt;
            cg_skip_off = s;
            cg_skip_len = 3 + 5 + 4LL * cnt;
          }
          break;
        }
        s = p + sz;
      }
    }
  }

  out->put_u(qname, l_qname - 1);
  out->putc_u('\t');
  out->put_i64_u(flag);
  out->putc_u('\t');
  if (tid >= 0 && tid < nt.n_ref) out->put_u(nt.buf + nt.offs[tid], nt.lens[tid]);
  else out->putc_u('*');
  out->putc_u('\t');
  out->put_i64_u((int64_t)pos + 1);
  out->putc_u('\t');
  out->put_i64_u(mapq);
  out->putc_u('\t');
  if (real_n_cigar == 0) out->putc_u('*');
  else {
    for (uint32_t k = 0; k < real_n_cigar; k++) {
      uint32_t c = rd_u32(real_cig + 4ull * k);
      out->put_i64_u(c >> 4);
      out->putc_u(kCigChar[c & 0xF]);
    }
  }
  out->putc_u('\t');
  if (mtid < 0) out->putc_u('*');
  else if (mtid == tid) out->putc_u('=');
  else if (mtid < nt.n_ref) out->put_u(nt.buf + nt.offs[mtid], nt.lens[mtid]);
  else out->putc_u('*');
  out->putc_u('\t');
  out->put_i64_u((int64_t)mpos + 1);
  out->putc_u('\t');
  out->put_i64_u(tlen);
  out->putc_u('\t');
  if (l_qseq == 0) out->putc_u('*');
  else {
    uint8_t* dst = out->data() + out->len();
#if defined(__SSSE3__)
    nibble2base_simd(seq, dst, l_qseq / 2);
#else
    for (int32_t i = 0; i < l_qseq / 2; i++) {
      uint16_t two = kNt16x2.t[seq[i]];
      memcpy(dst + 2 * i, &two, 2);
    }
#endif
    if (l_qseq & 1) dst[l_qseq - 1] = kNt16[seq[l_qseq / 2] >> 4];
    out->bump(l_qseq);
  }
  out->putc_u('\t');
  if (l_qseq == 0 || qual[0] == 0xFF) out->putc_u('*');
  else {
    uint8_t* dst = out->data() + out->len();
    for (int32_t i = 0; i < l_qseq; i++) dst[i] = qual[i] + 33;
    out->bump(l_qseq);
  }
  if (format_aux(aux, end - aux, cg_skip_off, cg_skip_len, out) < 0)
    return -1;
  out->putc_u('\n');
  return 0;
}

}  // namespace

extern "C" {

// Format n BAM records as SAM text, multithreaded by record ranges.
// Returns total byte length (caller then copies from *out_ptr and calls
// htstpu_buf_free), or -(3000+i) on a malformed record i.
int64_t htstpu_bam_to_sam(const uint8_t* data, const uint64_t* offs,
                          const uint32_t* sizes, int64_t n,
                          const uint8_t* name_buf, const uint64_t* name_offs,
                          const uint32_t* name_lens, int32_t n_ref,
                          uint8_t** out_ptr, int nthreads) {
  if (nthreads <= 0) nthreads = hardware_threads();
  NameTable nt{name_buf, name_offs, name_lens, n_ref};
  nt.max_name = nt.max_len();
  int shards = nthreads * 4;
  if (shards > n) shards = n ? (int)n : 1;
  std::vector<Buf> bufs(shards);
  std::atomic<int64_t> err(0);
  int64_t per = (n + shards - 1) / (shards ? shards : 1);
  parallel_for(shards, nthreads, [&](int64_t si) {
    int64_t lo = si * per, hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) return;
    // pre-size the shard buffer: SAM text runs ~2.2x the BAM record
    // bytes; with the host allocator's mmap path disabled every realloc
    // is a full copy, so growth-by-doubling would copy each shard twice
    uint64_t in_bytes = (offs[hi - 1] + sizes[hi - 1]) - offs[lo];
    bufs[si].reserve(in_bytes * 5 / 2 + 4096);
    for (int64_t i = lo; i < hi; i++) {
      if (format_record(data + offs[i] + 4, sizes[i] - 4, nt, &bufs[si]) < 0) {
        err.store(-(3000 + i), std::memory_order_relaxed);
        return;
      }
    }
  });
  if (err.load()) return err.load();
  int64_t total = 0;
  for (auto& b : bufs) total += b.len();
  uint8_t* out = (uint8_t*)malloc(total ? total : 1);
  if (!out) return -1;
  int64_t pos = 0;
  std::vector<int64_t> starts(shards);
  for (int i = 0; i < shards; i++) {
    starts[i] = pos;
    pos += bufs[i].len();
  }
  parallel_for(shards, nthreads, [&](int64_t si) {
    memcpy(out + starts[si], bufs[si].data(), bufs[si].len());
  });
  *out_ptr = out;
  return total;
}

// Fused record-scan + format pipeline over an uncompressed BAM byte
// stream (everything after the header).  A scanner walks the record
// framing (inherently sequential, sam.c:784) while format workers chase
// its frontier in fixed-size record batches — the serial scan overlaps
// with formatting instead of preceding it.  Returns total SAM byte
// length via *out_ptr (caller frees with htstpu_buf_free), or
// -2 truncated / -3 bad record / -(3000+i) malformed record i.
int64_t htstpu_bam_scan_format(const uint8_t* data, uint64_t len,
                               uint64_t start, const uint8_t* name_buf,
                               const uint64_t* name_offs,
                               const uint32_t* name_lens, int32_t n_ref,
                               uint8_t** out_ptr, int nthreads) {
  if (nthreads <= 0) nthreads = hardware_threads();
  NameTable nt{name_buf, name_offs, name_lens, n_ref};
  nt.max_name = nt.max_len();
  const int64_t kBatch = 4096;
  uint64_t cap = (len - start) / 36 + 1;  // 32B core + 4B size minimum
  std::vector<uint64_t> offs(cap);
  std::atomic<int64_t> n_scanned(0);
  std::atomic<int64_t> scan_err(0);
  std::atomic<bool> scan_done(false);
  std::atomic<int64_t> next_batch(0);
  std::atomic<int64_t> fmt_err(0);
  OrderedSink sink;
  if (!sink.init(sam_out_bound(len - start, nt.max_len()))) return -1;

  auto format_batches = [&]() {
    Buf scratch;  // reused across batches: stays cache-resident
    for (;;) {
      int64_t bi = next_batch.fetch_add(1, std::memory_order_relaxed);
      int64_t lo = bi * kBatch;
      // wait for the scanner to pass lo + kBatch (or finish)
      for (;;) {
        int64_t ns = n_scanned.load(std::memory_order_acquire);
        if (ns >= lo + kBatch || scan_done.load(std::memory_order_acquire))
          break;
        std::this_thread::yield();
      }
      int64_t total = n_scanned.load(std::memory_order_acquire);
      if (lo >= total) { sink.skip(bi, fmt_err); return; }
      int64_t hi = std::min<int64_t>(total, lo + kBatch);
      if (fmt_err.load(std::memory_order_relaxed) ||
          scan_err.load(std::memory_order_relaxed))
        return;
      scratch.clear();
      // exact batch byte span: records are contiguous in the stream
      uint32_t last_bsz;
      std::memcpy(&last_bsz, data + offs[hi - 1], 4);
      uint64_t in_bytes = offs[hi - 1] + 4 + last_bsz - offs[lo];
      scratch.reserve(in_bytes * 5 / 2 + 4096);
      for (int64_t i = lo; i < hi; i++) {
        uint32_t bsz;
        std::memcpy(&bsz, data + offs[i], 4);
        if (format_record(data + offs[i] + 4, bsz, nt, &scratch) < 0) {
          fmt_err.store(-(3000 + i), std::memory_order_relaxed);
          return;
        }
      }
      if (!sink.commit(bi, scratch.data(), scratch.len(), fmt_err)) return;
    }
  };

  if (nthreads > 6 && len - start > (16u << 20)) {
    // Wide team: parallel speculative scan, then format with every thread.
    int64_t n = spec_scan_records(data, len, start, n_ref, offs.data(), cap,
                                  nthreads);
    if (n < 0) scan_err.store(n);
    else n_scanned.store(n, std::memory_order_release);
    scan_done.store(true, std::memory_order_release);
    if (!scan_err.load()) {
      std::vector<std::thread> team;
      for (int i = 1; i < nthreads; i++) team.emplace_back(format_batches);
      format_batches();
      for (auto& th : team) th.join();
    }
  } else {
  std::vector<std::thread> team;
  for (int i = 1; i < nthreads; i++) team.emplace_back(format_batches);

  // scanner on the calling thread, then it joins the format pool
  {
    uint64_t pos = start;
    int64_t n = 0;
    while (pos + 4 <= len) {
      uint32_t bsz;
      std::memcpy(&bsz, data + pos, 4);
      if (pos + 4 + bsz > len) { scan_err.store(-2); break; }
      if (bsz < 32) { scan_err.store(-3); break; }
      offs[n++] = pos;
      __builtin_prefetch(data + pos + 1024);
      pos += 4 + (uint64_t)bsz;
      if ((n & 1023) == 0)
        n_scanned.store(n, std::memory_order_release);
    }
    if (!scan_err.load() && pos != len) scan_err.store(-2);
    n_scanned.store(n, std::memory_order_release);
    scan_done.store(true, std::memory_order_release);
  }
  format_batches();
  for (auto& th : team) th.join();
  }
  if (scan_err.load()) { sink.abandon(); return scan_err.load(); }
  if (fmt_err.load()) { sink.abandon(); return fmt_err.load(); }

  *out_ptr = sink.release();
  return (int64_t)sink.bytes.load();
}

void htstpu_buf_free(uint8_t* p) { free(p); }

// Container-planner column extraction over a u32-framed BAM record
// stream: tid/pos/flag plus bam_endpos's CIGAR reference span
// (htslib/sam.h bam_endpos) — the vectorised prologue of the CRAM
// file-level encode fast path, multithreaded by record ranges.
int64_t htstpu_bam_fields(const uint8_t* data, uint64_t data_len,
                          const int64_t* offs, int64_t n,
                          int32_t* tids, int32_t* poss, int64_t* ends,
                          int32_t* flags) {
  std::atomic<int64_t> err(0);
  int nthreads = hardware_threads();
  int shards = nthreads * 2;
  if (shards > n) shards = n ? (int)n : 1;
  int64_t per = (n + shards - 1) / (shards ? shards : 1);
  parallel_for(shards, nthreads, [&](int64_t si) {
    int64_t lo = si * per, hi = std::min<int64_t>(n, lo + per);
    for (int64_t i = lo; i < hi; i++) {
      uint64_t o = (uint64_t)offs[i];
      if (o + 36 > data_len) { err.store(i + 1); return; }
      const uint8_t* p = data + o + 4;
      int32_t tid = (int32_t)rd_u32(p + 0);
      int32_t pos = (int32_t)rd_u32(p + 4);
      uint32_t l_qname = p[8];
      uint32_t n_cigar = rd_u16(p + 12);
      uint32_t flag = rd_u16(p + 14);
      int64_t span = 0;
      if (!(flag & 4) && n_cigar) {
        const uint8_t* cp = p + 32 + l_qname;
        for (uint32_t k = 0; k < n_cigar; k++) {
          uint32_t c = rd_u32(cp + 4ull * k);
          uint32_t op = c & 0xF;
          // M/D/N/=/X consume reference
          if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
            span += c >> 4;
        }
      }
      tids[i] = tid;
      poss[i] = pos;
      flags[i] = (int32_t)flag;
      ends[i] = (int64_t)pos + (span > 0 ? span : 1);
    }
  });
  return err.load() ? -err.load() : 0;
}

// Plain gzip-container compress/decompress for CRAM block methods
// (cram_compress_block GZIP leg, cram/cram_io.c:1604: zlib wbits 31) —
// libdeflate, ~2-3x zlib at the same levels.  Returns compressed size
// via return value, buffer via *out_ptr (htstpu_buf_free).
int64_t htstpu_gzip_compress(const uint8_t* in, uint64_t n, int32_t level,
                             uint8_t** out_ptr) {
  if (level < 1) level = 6;
  if (level > 12) level = 12;
  struct libdeflate_compressor* c = tl_compressor(level);
  if (!c) return -1;
  size_t bound = libdeflate_gzip_compress_bound(c, (size_t)n);
  uint8_t* buf = (uint8_t*)malloc(bound ? bound : 1);
  if (!buf) return -1;
  size_t sz = libdeflate_gzip_compress(c, in, (size_t)n, buf, bound);
  if (sz == 0) { free(buf); return -2; }
  *out_ptr = buf;
  return (int64_t)sz;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fully fused BGZF -> SAM pipeline: block inflate + record scan + format in
// one thread team (the batch analogue of htslib's reader-thread + pool +
// ordered-drain MT pipeline, bgzf.c:1598 / sam.c:3325)
// ---------------------------------------------------------------------------

namespace {

struct DecompHolder {
  libdeflate_decompressor* d = nullptr;
  ~DecompHolder() {
    if (d) libdeflate_free_decompressor(d);
  }
  libdeflate_decompressor* get() {
    if (!d) d = libdeflate_alloc_decompressor();
    return d;
  }
};
thread_local DecompHolder t_decomp;

}  // namespace

extern "C" {

// One call does everything the BAM->SAM hot path needs, overlapping all
// three stages: workers inflate BGZF members into a shared uncompressed
// buffer, the calling thread walks the record framing chasing the inflate
// frontier (stealing inflate work while blocked), and workers that run out
// of inflate jobs switch to formatting scanned record batches.  `u_skip` is
// the uncompressed byte length of the BAM header to skip.  Returns total
// SAM text length via *out_ptr (htstpu_buf_free to release), or
// -2 truncated / -3 bad record / -(1000+i) inflate failure in block i /
// -(3000+i) malformed record i.
int64_t htstpu_bgzf_to_sam(const uint8_t* raw, uint64_t rlen, uint64_t u_skip,
                           const uint8_t* name_buf, const uint64_t* name_offs,
                           const uint32_t* name_lens, int32_t n_ref,
                           int verify_crc, uint8_t** out_ptr, int nthreads) {
  if (nthreads <= 0) nthreads = hardware_threads();
  NameTable nt{name_buf, name_offs, name_lens, n_ref};
  nt.max_name = nt.max_len();

  // 1. serial member scan (BSIZE hop; trivially cheap vs inflate)
  std::vector<uint64_t> coffs, uoffs;
  std::vector<uint32_t> csizes, usizes;
  {
    uint64_t pos = 0, uo = 0;
    while (pos + kBlockHeader <= rlen) {
      int64_t total = parse_bsize(raw + pos, rlen - pos);
      if (total < 0) return -3;
      if (pos + (uint64_t)total > rlen) return -2;
      uint32_t isize;
      std::memcpy(&isize, raw + pos + total - 4, 4);
      coffs.push_back(pos);
      csizes.push_back((uint32_t)total);
      usizes.push_back(isize);
      uoffs.push_back(uo);
      uo += isize;
      pos += total;
    }
    if (pos != rlen) return -2;
  }
  int64_t nblk = (int64_t)coffs.size();
  uint64_t U = nblk ? uoffs[nblk - 1] + usizes[nblk - 1] : 0;
  if (u_skip > U) return -2;
  uint64_t ubuf_cap = U ? U : 4096;
  uint8_t* ubuf = big_alloc(ubuf_cap);
  if (!ubuf) return -1;

  // 2. shared pipeline state
  std::atomic<int64_t> next_blk(0);
  std::vector<std::atomic<uint8_t>> done(nblk);
  for (auto& d : done) d.store(0, std::memory_order_relaxed);
  std::atomic<int64_t> err(0);

  auto inflate_one = [&]() -> bool {
    int64_t i = next_blk.fetch_add(1, std::memory_order_relaxed);
    if (i >= nblk) return false;
    const uint8_t* p = raw + coffs[i];
    uint32_t csize = csizes[i], usize = usizes[i];
    unsigned xlen = p[10] | (p[11] << 8);
    if (12u + xlen + kBlockFooter > csize) {
      err.store(-(1000 + i), std::memory_order_relaxed);
      done[i].store(1, std::memory_order_release);
      return true;
    }
    const uint8_t* payload = p + 12 + xlen;
    size_t paylen = csize - (12 + xlen) - kBlockFooter;
    size_t actual = 0;
    enum libdeflate_result r = libdeflate_deflate_decompress(
        t_decomp.get(), payload, paylen, ubuf + uoffs[i], usize, &actual);
    if (r != LIBDEFLATE_SUCCESS || actual != usize) {
      err.store(-(1000 + i), std::memory_order_relaxed);
    } else if (verify_crc) {
      uint32_t want;
      std::memcpy(&want, p + csize - 8, 4);
      if (libdeflate_crc32(0, ubuf + uoffs[i], usize) != want)
        err.store(-(1000 + i), std::memory_order_relaxed);
    }
    done[i].store(1, std::memory_order_release);
    return true;
  };

  // record scan + format chase state (as htstpu_bam_scan_format)
  const int64_t kBatch = 4096;
  uint64_t cap = (U - u_skip) / 36 + 1;
  std::vector<uint64_t> offs(cap);
  std::atomic<int64_t> n_scanned(0);
  std::atomic<bool> scan_done(false);
  std::atomic<int64_t> next_batch(0);
  OrderedSink sink;
  if (!sink.init(sam_out_bound(U - u_skip, nt.max_len()))) {
    big_free(ubuf, ubuf_cap);
    return -1;
  }

  auto format_batches = [&]() {
    Buf scratch;  // reused across batches: stays cache-resident
    for (;;) {
      int64_t bi = next_batch.fetch_add(1, std::memory_order_relaxed);
      int64_t lo = bi * kBatch;
      for (;;) {
        int64_t ns = n_scanned.load(std::memory_order_acquire);
        if (ns >= lo + kBatch || scan_done.load(std::memory_order_acquire))
          break;
        if (err.load(std::memory_order_relaxed)) return;
        std::this_thread::yield();
      }
      int64_t total = n_scanned.load(std::memory_order_acquire);
      if (lo >= total) { sink.skip(bi, err); return; }
      int64_t hi = std::min<int64_t>(total, lo + kBatch);
      if (err.load(std::memory_order_relaxed)) return;
      scratch.clear();
      // exact batch byte span: records are contiguous in the stream
      uint32_t last_bsz;
      std::memcpy(&last_bsz, ubuf + offs[hi - 1], 4);
      uint64_t in_bytes = offs[hi - 1] + 4 + last_bsz - offs[lo];
      scratch.reserve(in_bytes * 5 / 2 + 4096);
      for (int64_t i = lo; i < hi; i++) {
        uint32_t bsz;
        std::memcpy(&bsz, ubuf + offs[i], 4);
        if (format_record(ubuf + offs[i] + 4, bsz, nt, &scratch) < 0) {
          err.store(-(3000 + i), std::memory_order_relaxed);
          return;
        }
      }
      if (!sink.commit(bi, scratch.data(), scratch.len(), err)) return;
    }
  };

  auto worker = [&]() {
    while (inflate_one()) {
      if (err.load(std::memory_order_relaxed)) break;
    }
    format_batches();
  };

  if (nthreads > 6 && nblk >= nthreads) {
    // Wide team: the serial frontier-chasing scanner would be the Amdahl
    // wall, so run in phases — (1) inflate with every thread, (2) parallel
    // speculative record scan, (3) format with every thread.  The phase
    // barriers cost O(span/nthreads), which is negligible at this width.
    {
      std::vector<std::thread> t2;
      auto inflate_all = [&]() {
        while (inflate_one()) {
          if (err.load(std::memory_order_relaxed)) break;
        }
      };
      for (int i = 1; i < nthreads; i++) t2.emplace_back(inflate_all);
      inflate_all();
      for (auto& th : t2) th.join();
    }
    if (!err.load()) {
      int64_t n = spec_scan_records(ubuf, U, u_skip, n_ref, offs.data(), cap,
                                    nthreads);
      if (n < 0) err.store(n);
      else n_scanned.store(n, std::memory_order_release);
    }
    scan_done.store(true, std::memory_order_release);
    if (!err.load()) {
      std::vector<std::thread> t3;
      for (int i = 1; i < nthreads; i++) t3.emplace_back(format_batches);
      format_batches();
      for (auto& th : t3) th.join();
    }
  } else {
  std::vector<std::thread> team;
  for (int i = 1; i < nthreads; i++) team.emplace_back(worker);

  // 3. scanner on the calling thread: chase the inflate frontier, stealing
  // inflate jobs while blocked on not-yet-decompressed bytes
  {
    int64_t fblk = 0;
    uint64_t frontier = 0;
    auto wait_frontier = [&](uint64_t need) -> bool {
      for (;;) {
        while (fblk < nblk && done[fblk].load(std::memory_order_acquire)) {
          frontier = uoffs[fblk] + usizes[fblk];
          fblk++;
        }
        if (frontier >= need || fblk >= nblk) return frontier >= need;
        if (err.load(std::memory_order_relaxed)) return false;
        if (!inflate_one()) std::this_thread::yield();
      }
    };
    uint64_t pos = u_skip;
    int64_t n = 0;
    for (;;) {
      if (pos == U) break;
      if (pos + 4 > U) { err.store(-2); break; }
      if (!wait_frontier(pos + 4)) break;
      uint32_t bsz;
      std::memcpy(&bsz, ubuf + pos, 4);
      if (bsz < 32 || pos + 4 + (uint64_t)bsz > U) {
        err.store(bsz < 32 ? -3 : -2);
        break;
      }
      if (!wait_frontier(pos + 4 + bsz)) break;
      offs[n++] = pos;
      __builtin_prefetch(ubuf + pos + 1024);
      pos += 4 + (uint64_t)bsz;
      if ((n & 1023) == 0) n_scanned.store(n, std::memory_order_release);
    }
    n_scanned.store(n, std::memory_order_release);
    scan_done.store(true, std::memory_order_release);
  }
  format_batches();
  for (auto& th : team) th.join();
  }

  int64_t e = err.load();
  big_free(ubuf, ubuf_cap);
  if (e) {
    sink.abandon();
    return e;
  }

  *out_ptr = sink.release();
  return (int64_t)sink.bytes.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SAM text -> BAM record-stream parsing (sam_parse_worker equivalent,
// batch form; semantics mirror sam_parse1 sam.c:2662)
// ---------------------------------------------------------------------------

namespace {

// ASCII base -> nt16 code (hts.c:239 seq_nt16_table: '='ACMGRSVTWYHKDBN,
// lowercase, legacy digits 0-3, U->T)
struct Nt16Enc {
  uint8_t t[256];
  Nt16Enc() {
    memset(t, 15, sizeof(t));
    for (int i = 0; i < 16; i++) {
      t[(uint8_t)kNt16[i]] = i;
      t[(uint8_t)tolower(kNt16[i])] = i;
    }
    for (int i = 0; i < 4; i++) t[(uint8_t)('0' + i)] = 1 << i;
    t['U'] = 8; t['u'] = 8;
  }
};
const Nt16Enc kNt16Enc;

// AVX2 fast paths for the two byte-crunching loops of SAM parse: seq
// nibble packing and qual rebasing (the simd.c nibble2base analogue,
// in the encode direction).  Both return false on any byte outside the
// fast domain (non-ACGTN base, qual < '!'), and the caller re-runs the
// scalar loop which handles the full alphabet / reports the error.
#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("avx2"))) bool pack_seq_avx2(const char* seq, int32_t n,
                                                   uint8_t* dst) {
  int32_t i = 0;
  const __m256i mul = _mm256_set1_epi16(0x0110);  // bytes [16, 1]
  for (; i + 32 <= n; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(seq + i));
    __m256i code = _mm256_setzero_si256();
    __m256i seen = _mm256_setzero_si256();
    // nt16 codes (hts.c:239): A=1 C=2 G=4 T=8 N=15
    const struct { char ch; char c; } tab[5] = {
        {'A', 1}, {'C', 2}, {'G', 4}, {'T', 8}, {'N', 15}};
    for (const auto& e : tab) {
      __m256i m = _mm256_cmpeq_epi8(v, _mm256_set1_epi8(e.ch));
      code = _mm256_or_si256(code,
                             _mm256_and_si256(m, _mm256_set1_epi8(e.c)));
      seen = _mm256_or_si256(seen, m);
    }
    if (_mm256_movemask_epi8(seen) != -1) return false;
    // pairwise hi*16 + lo, then narrow 16 epi16 -> 16 bytes
    __m256i h = _mm256_maddubs_epi16(code, mul);
    __m256i packed = _mm256_packus_epi16(h, h);
    packed = _mm256_permute4x64_epi64(packed, 0x08);
    _mm_storeu_si128((__m128i*)(dst + i / 2),
                     _mm256_castsi256_si128(packed));
  }
  for (; i + 2 <= n; i += 2)
    dst[i / 2] = (kNt16Enc.t[(uint8_t)seq[i]] << 4) |
                 kNt16Enc.t[(uint8_t)seq[i + 1]];
  if (n & 1) dst[n / 2] = kNt16Enc.t[(uint8_t)seq[n - 1]] << 4;
  return true;
}

__attribute__((target("avx2"))) bool rebase_qual_avx2(const char* q, int32_t n,
                                                      uint8_t* dst) {
  int32_t i = 0;
  const __m256i c32 = _mm256_set1_epi8(32);
  const __m256i c33 = _mm256_set1_epi8(33);
  for (; i + 32 <= n; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(q + i));
    // signed compare matches the scalar `(char)q[i] < 33` check, so
    // bytes >= 0x80 also take the slow path (and its error report)
    if (_mm256_movemask_epi8(_mm256_cmpgt_epi8(v, c32)) != -1) return false;
    _mm256_storeu_si256((__m256i*)(dst + i), _mm256_sub_epi8(v, c33));
  }
  for (; i < n; i++) {
    if (q[i] < 33) return false;
    dst[i] = (uint8_t)(q[i] - 33);
  }
  return true;
}

const bool kHaveAvx2 = __builtin_cpu_supports("avx2");
#else
inline bool pack_seq_avx2(const char*, int32_t, uint8_t*) { return false; }
inline bool rebase_qual_avx2(const char*, int32_t, uint8_t*) { return false; }
const bool kHaveAvx2 = false;
#endif

// CIGAR op char -> code ("MIDNSHP=XB", sam.h BAM_CIGAR_STR)
struct CigEnc {
  int8_t t[256];
  CigEnc() {
    memset(t, -1, sizeof(t));
    const char* s = "MIDNSHP=XB";
    for (int i = 0; s[i]; i++) t[(uint8_t)s[i]] = i;
  }
};
const CigEnc kCigEnc;

inline int32_t reg2bin_c(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return (int32_t)(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return (int32_t)(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return (int32_t)(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return (int32_t)(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return (int32_t)(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

inline bool parse_i64(const char* p, const char* end, int64_t* out) {
  if (p >= end) return false;
  bool neg = false;
  if (*p == '-') { neg = true; p++; }
  else if (*p == '+') p++;
  if (p >= end) return false;
  // overflow is a parse error, not UB (hts_str2int clamps and flags,
  // hts.c; the callers here treat any overflow as a malformed line)
  uint64_t v = 0;
  for (; p < end; p++) {
    if (*p < '0' || *p > '9') return false;
    uint64_t d = (uint64_t)(*p - '0');
    if (v > (UINT64_MAX - d) / 10) return false;
    v = v * 10 + d;
  }
  if (neg) {
    if (v > (uint64_t)INT64_MAX + 1) return false;
    *out = v == (uint64_t)INT64_MAX + 1 ? INT64_MIN : -(int64_t)v;
  } else {
    if (v > (uint64_t)INT64_MAX) return false;
    *out = (int64_t)v;
  }
  return true;
}

inline void put_smallest_int(Buf* out, int64_t x) {
  // _encode_int_aux semantics (sam.c:2570 aux 'i' storage)
  if (x < 0) {
    if (x >= -128) { out->putc('c'); out->putc((char)(int8_t)x); }
    else if (x >= -32768) { int16_t v = (int16_t)x; out->putc('s'); out->put(&v, 2); }
    else { int32_t v = (int32_t)x; out->putc('i'); out->put(&v, 4); }
  } else if (x <= 0xFF) { out->putc('C'); out->putc((char)(uint8_t)x); }
  else if (x <= 0xFFFF) { uint16_t v = (uint16_t)x; out->putc('S'); out->put(&v, 2); }
  else { uint32_t v = (uint32_t)x; out->putc('I'); out->put(&v, 4); }
}

inline bool fits_sub(int64_t v, char sub) {
  switch (sub) {
    case 'c': return v >= -128 && v <= 127;
    case 'C': return v >= 0 && v <= 255;
    case 's': return v >= -32768 && v <= 32767;
    case 'S': return v >= 0 && v <= 65535;
    case 'i': return v >= INT32_MIN && v <= INT32_MAX;
    case 'I': return v >= 0 && v <= (int64_t)UINT32_MAX;
  }
  return false;
}

inline void put_sub(Buf* out, int64_t v, char sub) {
  switch (sub) {
    case 'c': case 'C': out->putc((char)(uint8_t)v); break;
    case 's': case 'S': { uint16_t x = (uint16_t)v; out->put(&x, 2); break; }
    default: { uint32_t x = (uint32_t)v; out->put(&x, 4); break; }
  }
}

struct SamParseCtx {
  const std::unordered_map<std::string, int32_t>* names;
  std::vector<uint32_t> cigar;   // scratch
  std::vector<int64_t> bvals;    // scratch
  Buf aux;                       // scratch (reset per record)
  Buf payload;                   // scratch (reset per record)
};

// Parse one SAM line [p, end) into out (u32 block_size + payload framing).
// Returns 0 or a negative reason.
int parse_sam_line(const char* p, const char* end, SamParseCtx* ctx,
                   Buf* out) {
  // split into fields
  const char* f[12];
  const char* fe[12];
  int nf = 0;
  const char* q = p;
  while (q <= end && nf < 12) {
    const char* t = (const char*)memchr(q, '\t', end - q);
    f[nf] = q;
    fe[nf] = t ? t : end;
    q = (t ? t + 1 : end + 1);
    nf++;
    if (nf == 12) { fe[11] = end; break; }  // rest = aux region
  }
  if (nf < 11) return -1;
  bool has_aux = nf == 12;

  // qname
  size_t l_qname = fe[0] - f[0];
  if (l_qname == 0 || l_qname > 254) return -1;
  // flag (decimal or 0x hex)
  int64_t flag;
  if (fe[1] - f[1] > 2 && f[1][0] == '0' && (f[1][1] == 'x' || f[1][1] == 'X')) {
    flag = strtoll(std::string(f[1] + 2, fe[1]).c_str(), nullptr, 16);
  } else if (!parse_i64(f[1], fe[1], &flag)) return -1;
  if (flag < 0 || flag > 0xFFFF) return -1;  // 16-bit (sam.c flag parse)
  // rname -> tid
  int32_t tid = -1;
  if (!(fe[2] - f[2] == 1 && *f[2] == '*')) {
    auto it = ctx->names->find(std::string(f[2], fe[2]));
    if (it == ctx->names->end()) return -2;  // unknown ref: python fallback
    tid = it->second;
  }
  int64_t pos1, mapq, mpos1, tlen;
  if (!parse_i64(f[3], fe[3], &pos1)) return -1;
  if (pos1 < 0 || pos1 - 1 > INT32_MAX) return -1;  // BAM pos is int32
  int64_t pos = pos1 - 1;
  if (!parse_i64(f[4], fe[4], &mapq)) return -1;
  if (mapq < 0 || mapq > 0xFF) return -1;           // 8-bit (sam.c:2753)
  // cigar
  ctx->cigar.clear();
  if (!(fe[5] - f[5] == 1 && *f[5] == '*')) {
    const char* c = f[5];
    while (c < fe[5]) {
      uint32_t n = 0;
      if (*c < '0' || *c > '9') return -1;
      while (c < fe[5] && *c >= '0' && *c <= '9') {
        n = n * 10 + (uint32_t)(*c++ - '0');
        if (n > (1u << 28) - 1) return -1;  // 28-bit op length (sam.c:2873)
      }
      if (c >= fe[5]) return -1;
      int8_t op = kCigEnc.t[(uint8_t)*c++];
      if (op < 0) return -1;
      ctx->cigar.push_back(n << 4 | (uint32_t)op);
    }
  }
  if (!ctx->cigar.empty() && pos < 0) return -1;
  // rnext / pnext / tlen
  int32_t mtid = -1;
  if (fe[6] - f[6] == 1 && *f[6] == '=') mtid = tid;
  else if (!(fe[6] - f[6] == 1 && *f[6] == '*')) {
    auto it = ctx->names->find(std::string(f[6], fe[6]));
    if (it == ctx->names->end()) return -2;
    mtid = it->second;
  }
  if (!parse_i64(f[7], fe[7], &mpos1)) return -1;
  if (mpos1 < 0 || mpos1 - 1 > INT32_MAX) return -1;
  if (!parse_i64(f[8], fe[8], &tlen)) return -1;
  if (tlen < INT32_MIN || tlen > INT32_MAX) return -1;
  // seq / qual
  const char* seq = f[9];
  int32_t l_qseq = 0;
  bool has_seq = !(fe[9] - f[9] == 1 && *f[9] == '*');
  if (has_seq) l_qseq = (int32_t)(fe[9] - f[9]);
  bool has_qual = !(fe[10] - f[10] == 1 && *f[10] == '*');
  if (has_qual && !has_seq) return -1;       // QUAL without SEQ
  if (has_qual && fe[10] - f[10] != l_qseq) return -1;
  // CIGAR qlen consistency
  if (!ctx->cigar.empty() && l_qseq) {
    int64_t qlen = 0;
    for (uint32_t c : ctx->cigar) {
      int op = c & 0xF;
      if (op == 0 || op == 1 || op == 4 || op == 7 || op == 8)
        qlen += c >> 4;
    }
    if (qlen != l_qseq) return -1;
  }
  int64_t rlen = 0;
  for (uint32_t c : ctx->cigar) {
    int op = c & 0xF;
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rlen += c >> 4;
  }
  int32_t bin = pos >= 0 ? reg2bin_c(pos, pos + (rlen ? rlen : 1))
                         : reg2bin_c(-1, 0);

  // aux fields
  ctx->aux.clear();
  Buf* aux = &ctx->aux;
  int64_t cg_tag_off = -1, cg_data_off = -1, cg_n = 0;
  if (has_aux) {
    const char* a = f[11];
    while (a < end) {
      const char* t = (const char*)memchr(a, '\t', end - a);
      const char* ae = t ? t : end;
      if (ae - a < 5 || a[2] != ':' || a[4] != ':') return -1;
      char type = a[3];
      const char* v = a + 5;
      int64_t tag_off = (int64_t)aux->len();
      aux->put(a, 2);
      switch (type) {
        case 'A': case 'a': case 'c': case 'C':
          if (ae - v < 1) return -1;
          aux->putc('A'); aux->putc(*v);
          break;
        case 'i': case 'I': {
          int64_t x;
          if (!parse_i64(v, ae, &x)) return -1;
          // 32-bit clamp with overflow-as-error (sam.c:2593-2607)
          if (x < INT32_MIN || x > (int64_t)UINT32_MAX) return -1;
          put_smallest_int(aux, x);
          break;
        }
        case 'f': {
          float fv = strtof(std::string(v, ae).c_str(), nullptr);
          aux->putc('f'); aux->put(&fv, 4);
          break;
        }
        case 'd': {
          double dv = strtod(std::string(v, ae).c_str(), nullptr);
          aux->putc('d'); aux->put(&dv, 8);
          break;
        }
        case 'Z':
          aux->putc('Z'); aux->put(v, ae - v); aux->putc('\0');
          break;
        case 'H':
          if ((ae - v) % 2) return -1;
          aux->putc('H'); aux->put(v, ae - v); aux->putc('\0');
          break;
        case 'B': {
          if (ae - v < 1) return -1;
          char sub = *v;
          const char* iv = v + 1;
          if (iv < ae && *iv != ',') return -1;
          if (sub == 'f') {
            aux->putc('B'); aux->putc('f');
            int64_t noff = (int64_t)aux->len();
            uint32_t n = 0; aux->put(&n, 4);
            while (iv < ae) {
              iv++;  // skip ','
              const char* c2 = (const char*)memchr(iv, ',', ae - iv);
              const char* ve = c2 ? c2 : ae;
              float fv = strtof(std::string(iv, ve).c_str(), nullptr);
              aux->put(&fv, 4);
              n++;
              iv = ve;
            }
            memcpy(aux->data() + noff, &n, 4);
          } else {
            if (!strchr("cCsSiI", sub)) return -1;
            ctx->bvals.clear();
            bool fit = true;
            while (iv < ae) {
              iv++;
              const char* c2 = (const char*)memchr(iv, ',', ae - iv);
              const char* ve = c2 ? c2 : ae;
              int64_t x;
              if (!parse_i64(iv, ve, &x)) return -1;
              if (!fits_sub(x, sub)) fit = false;
              ctx->bvals.push_back(x);
              iv = ve;
            }
            char use = sub;
            if (!fit) {
              // widen to the smallest covering type
              // (sam_parse_B_vals_r retry, sam.c:2452-2485)
              int64_t mn = 0, mx = 0;
              for (int64_t x : ctx->bvals) { mn = std::min(mn, x); mx = std::max(mx, x); }
              if (mn < 0) {
                if (mn >= -128 && mx <= 127) use = 'c';
                else if (mn >= -32768 && mx <= 32767) use = 's';
                else if (mn >= INT32_MIN && mx <= INT32_MAX) use = 'i';
                else return -1;
              } else {
                if (mx < 0xFF) use = 'C';
                else if (mx <= 0xFFFF) use = 'S';
                else if (mx <= (int64_t)UINT32_MAX) use = 'I';
                else return -1;
              }
            }
            if (a[0] == 'C' && a[1] == 'G' && (use == 'I' || use == 'i')) {
              cg_tag_off = tag_off;
              cg_n = (int64_t)ctx->bvals.size();
            }
            aux->putc('B'); aux->putc(use);
            uint32_t n = (uint32_t)ctx->bvals.size();
            aux->put(&n, 4);
            if (a[0] == 'C' && a[1] == 'G' && (use == 'I' || use == 'i'))
              cg_data_off = (int64_t)aux->len();
            for (int64_t x : ctx->bvals) put_sub(aux, x, use);
          }
          break;
        }
        default:
          return -1;
      }
      a = (t ? t + 1 : end);
    }
  }

  // CG long-CIGAR promotion (bam_tag2cigar, sam.c:680)
  uint32_t* cig = ctx->cigar.data();
  size_t n_cigar = ctx->cigar.size();
  std::vector<uint32_t> promoted;
  if (n_cigar > 0 && tid >= 0 && pos >= 0 && cg_tag_off >= 0 &&
      cig[0] == (((uint32_t)l_qseq << 4) | 4) &&
      cg_n >= (int64_t)n_cigar && cg_n < (1ll << 29)) {
    promoted.resize(cg_n);
    memcpy(promoted.data(), aux->data() + cg_data_off, 4 * cg_n);
    // remove the CG tag from aux
    int64_t cg_end2 = cg_data_off + 4 * cg_n;
    int64_t tail = (int64_t)aux->len() - cg_end2;
    memmove(aux->data() + cg_tag_off, aux->data() + cg_end2, tail);
    aux->set_len(cg_tag_off + tail);
    cig = promoted.data();
    n_cigar = promoted.size();
    int64_t rl = 0;
    for (size_t i2 = 0; i2 < n_cigar; i2++) {
      int op = cig[i2] & 0xF;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
        rl += cig[i2] >> 4;
    }
    if (flag & 4) rl = 0;
    bin = reg2bin_c(pos, pos + (rl ? rl : 1));
  }
  if (n_cigar > 0xFFFF) return -2;  // CG escape on write: python fallback

  // emit framed record
  uint32_t bsz = (uint32_t)(32 + l_qname + 1 + 4 * n_cigar +
                            (l_qseq + 1) / 2 + l_qseq + aux->len());
  out->reserve(4 + bsz);
  out->put(&bsz, 4);
  int32_t i32;
  i32 = tid; out->put(&i32, 4);
  i32 = (int32_t)pos; out->put(&i32, 4);
  out->putc((char)(uint8_t)(l_qname + 1));
  out->putc((char)(uint8_t)mapq);
  uint16_t u16 = (uint16_t)bin; out->put(&u16, 2);
  u16 = (uint16_t)n_cigar; out->put(&u16, 2);
  u16 = (uint16_t)flag; out->put(&u16, 2);
  i32 = l_qseq; out->put(&i32, 4);
  i32 = mtid; out->put(&i32, 4);
  i32 = (int32_t)(mpos1 - 1); out->put(&i32, 4);
  i32 = (int32_t)tlen; out->put(&i32, 4);
  out->put(f[0], l_qname); out->putc('\0');
  out->put(cig, 4 * n_cigar);
  // packed seq nibbles
  if (l_qseq) {
    out->reserve((l_qseq + 1) / 2);
    uint8_t* dst = out->data() + out->len();
    if (!(kHaveAvx2 && pack_seq_avx2(seq, l_qseq, dst))) {
      for (int32_t i2 = 0; i2 < l_qseq / 2; i2++)
        dst[i2] = (kNt16Enc.t[(uint8_t)seq[2 * i2]] << 4) |
                  kNt16Enc.t[(uint8_t)seq[2 * i2 + 1]];
      if (l_qseq & 1)
        dst[l_qseq / 2] = kNt16Enc.t[(uint8_t)seq[l_qseq - 1]] << 4;
    }
    out->bump((l_qseq + 1) / 2);
    // quals
    out->reserve(l_qseq);
    uint8_t* qd = out->data() + out->len();
    if (has_qual) {
      if (!(kHaveAvx2 && rebase_qual_avx2(f[10], l_qseq, qd))) {
        for (int32_t i2 = 0; i2 < l_qseq; i2++) {
          if (f[10][i2] < 33) return -1;
          qd[i2] = (uint8_t)(f[10][i2] - 33);
        }
      }
    } else {
      memset(qd, 0xFF, l_qseq);
    }
    out->bump(l_qseq);
  }
  out->put(aux->data(), aux->len());
  return 0;
}

}  // namespace

extern "C" {

// Parse SAM text (body lines; '@' header lines and blanks are skipped)
// into a BAM record stream (u32 block_size + payload per record).
// Returns total bytes via *out_ptr (htstpu_buf_free to release), or
// -(4000+line_index) for a malformed/fallback-needed line.
int64_t htstpu_sam_to_bam(const uint8_t* text, uint64_t len,
                          const uint8_t* name_buf, const uint64_t* name_offs,
                          const uint32_t* name_lens, int32_t n_ref,
                          uint8_t** out_ptr, int nthreads) {
  if (nthreads <= 0) nthreads = hardware_threads();
  std::unordered_map<std::string, int32_t> names;
  names.reserve(n_ref * 2);
  for (int32_t i = 0; i < n_ref; i++)
    names.emplace(std::string((const char*)name_buf + name_offs[i],
                              name_lens[i]), i);
  // line table (skipping headers/blanks)
  std::vector<std::pair<uint64_t, uint64_t>> lines;
  const char* p = (const char*)text;
  uint64_t pos = 0;
  while (pos < len) {
    const char* nl = (const char*)memchr(p + pos, '\n', len - pos);
    uint64_t e = nl ? (uint64_t)(nl - p) : len;
    uint64_t e2 = e;
    if (e2 > pos && p[e2 - 1] == '\r') e2--;
    if (e2 > pos && p[pos] != '@')
      lines.emplace_back(pos, e2);
    pos = e + 1;
  }
  int64_t n = (int64_t)lines.size();
  int shards = nthreads * 4;
  if (shards > n) shards = n ? (int)n : 1;
  std::vector<Buf> bufs(shards);
  std::atomic<int64_t> err(0);
  int64_t per = (n + shards - 1) / (shards ? shards : 1);
  parallel_for(shards, nthreads, [&](int64_t si) {
    SamParseCtx ctx;
    ctx.names = &names;
    int64_t lo = si * per, hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) return;
    bufs[si].reserve((lines[hi - 1].second - lines[lo].first) + 4096);
    for (int64_t i = lo; i < hi; i++) {
      if (parse_sam_line(p + lines[i].first, p + lines[i].second, &ctx,
                         &bufs[si]) < 0) {
        err.store(-(4000 + i), std::memory_order_relaxed);
        return;
      }
    }
  });
  if (err.load()) return err.load();
  int64_t total = 0;
  for (auto& b : bufs) total += b.len();
  uint8_t* out = (uint8_t*)malloc(total ? total : 1);
  if (!out) return -1;
  std::vector<int64_t> starts(shards);
  int64_t acc = 0;
  for (int i = 0; i < shards; i++) { starts[i] = acc; acc += bufs[i].len(); }
  parallel_for(shards, nthreads, [&](int64_t si) {
    memcpy(out + starts[si], bufs[si].data(), bufs[si].len());
  });
  *out_ptr = out;
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// rANS 4x8 — the CRAM 3.0 static rANS entropy codec (htscodecs
// rANS_static.c, reached via cram/cram_io.c:1668/1838).  Same wire format
// as htslib_tpu/codecs/rans4x8.py; this is the production host route, the
// Python/numpy and TPU (ops/rans.py) paths are the fallbacks/device mirrors.
// All decode paths treat input as hostile: every read is bounds-checked.
// ---------------------------------------------------------------------------

namespace {

constexpr int kTfShift = 12;
constexpr uint32_t kTotFreq = 1u << kTfShift;
constexpr uint32_t kRansL = 1u << 23;

// ITF8 (cram/cram_io.c:138): leading-ones prefix gives the byte count.
inline bool itf8_get(const uint8_t* b, uint64_t len, uint64_t* p, uint32_t* v) {
  if (*p >= len) return false;
  uint8_t b0 = b[*p];
  int extra = b0 < 0x80 ? 0 : b0 < 0xC0 ? 1 : b0 < 0xE0 ? 2 : b0 < 0xF0 ? 3 : 4;
  if (*p + 1 + extra > len) return false;
  const uint8_t* q = b + *p + 1;
  switch (extra) {
    case 0: *v = b0; break;
    case 1: *v = ((b0 & 0x3Fu) << 8) | q[0]; break;
    case 2: *v = ((b0 & 0x1Fu) << 16) | (q[0] << 8) | q[1]; break;
    case 3: *v = ((b0 & 0x0Fu) << 24) | (q[0] << 16) | (q[1] << 8) | q[2]; break;
    default:
      *v = ((b0 & 0x0Fu) << 28) | (q[0] << 20) | (q[1] << 12) | (q[2] << 4) |
           (q[3] & 0x0F);
      break;
  }
  *p += 1 + extra;
  return true;
}

inline void itf8_put(Buf* out, uint32_t v) {
  if (v < 0x80) { out->putc((char)v); }
  else if (v < 0x4000) {
    out->putc((char)(0x80 | (v >> 8))); out->putc((char)(v & 0xFF));
  } else if (v < 0x200000) {
    out->putc((char)(0xC0 | (v >> 16))); out->putc((char)((v >> 8) & 0xFF));
    out->putc((char)(v & 0xFF));
  } else if (v < 0x10000000) {
    out->putc((char)(0xE0 | (v >> 24))); out->putc((char)((v >> 16) & 0xFF));
    out->putc((char)((v >> 8) & 0xFF)); out->putc((char)(v & 0xFF));
  } else {
    out->putc((char)(0xF0 | ((v >> 28) & 0x0F))); out->putc((char)((v >> 20) & 0xFF));
    out->putc((char)((v >> 12) & 0xFF)); out->putc((char)((v >> 4) & 0xFF));
    out->putc((char)(v & 0x0F));
  }
}

// One symbol->freq table: ascending symbol list with (sym, sym+1, runlen)
// RLE escape, ITF8 freqs, terminated by symbol 0.
bool rans_read_freqs(const uint8_t* b, uint64_t len, uint64_t* pp,
                     uint32_t freqs[256]) {
  memset(freqs, 0, 256 * sizeof(uint32_t));
  uint64_t p = *pp;
  if (p >= len) return false;
  int sym = b[p++];
  int rle = 0;
  for (;;) {
    uint32_t f;
    if (!itf8_get(b, len, &p, &f)) return false;
    freqs[sym] = f;
    if (rle == 0 && p < len && b[p] == sym + 1) {
      sym = b[p++];
      if (p >= len) return false;
      rle = b[p++];
    } else if (rle > 0) {
      rle--;
      sym++;
      if (sym > 255) return false;
    } else {
      if (p >= len) return false;
      sym = b[p++];
    }
    if (sym == 0) break;
  }
  *pp = p;
  return true;
}

void rans_write_freqs(Buf* out, const uint32_t freqs[256]) {
  uint8_t syms[256];
  int n = 0;
  for (int s = 0; s < 256; s++)
    if (freqs[s]) syms[n++] = (uint8_t)s;
  int i = 0;
  while (i < n) {
    int run = 0;
    while (i + run + 1 < n && syms[i + run + 1] == syms[i + run] + 1) run++;
    out->putc((char)syms[i]);
    itf8_put(out, freqs[syms[i]]);
    if (run >= 1) {
      out->putc((char)(syms[i] + 1));
      out->putc((char)(run - 1));
      for (int j = 1; j <= run; j++) itf8_put(out, freqs[syms[i + j]]);
      i += run + 1;
    } else {
      i++;
    }
  }
  out->putc('\0');
}

// Scale freqs to sum kTotFreq keeping nonzero symbols nonzero
// (codecs/rans4x8.py _normalize semantics).
bool rans_normalize(const uint64_t* hist, uint32_t freqs[256]) {
  uint64_t s = 0;
  for (int i = 0; i < 256; i++) s += hist[i];
  if (s == 0) { memset(freqs, 0, 256 * sizeof(uint32_t)); return true; }
  int64_t total = 0;
  int argmax = 0;
  for (int i = 0; i < 256; i++) {
    uint64_t f = hist[i] * kTotFreq / s;
    if (hist[i] && f == 0) f = 1;
    freqs[i] = (uint32_t)f;
    total += (int64_t)f;
    if (freqs[i] > freqs[argmax]) argmax = i;
  }
  int64_t diff = (int64_t)kTotFreq - total;
  if ((int64_t)freqs[argmax] + diff <= 0) return false;
  freqs[argmax] = (uint32_t)((int64_t)freqs[argmax] + diff);
  return true;
}

struct RansTbl {
  // one 16 KiB L1-resident array: sym | (freq-1)<<8 | cum<<20 per slot
  uint32_t ent[kTotFreq];
  uint8_t sym_at(uint32_t m) const { return (uint8_t)ent[m]; }
  uint32_t freq_at(uint32_t m) const { return ((ent[m] >> 8) & 0xFFF) + 1; }
  uint32_t cum_at(uint32_t m) const { return ent[m] >> 20; }
  bool build(const uint32_t freqs[256]) {
    uint32_t c = 0;
    for (int s = 0; s < 256; s++) {
      uint32_t f = freqs[s];
      if (c + f > kTotFreq) return false;
      for (uint32_t k = 0; k < f; k++)
        ent[c + k] = (uint32_t)s | ((f - 1) << 8) | (c << 20);
      c += f;
    }
    // tail slots unused when sum < 4096 (rounding-tolerant tables);
    // freq-1 encoding keeps the decoder multiplier at 1 there
    for (; c < kTotFreq; c++) ent[c] = 0;
    return true;
  }
};

inline void rans_renorm_dec(uint32_t* x, const uint8_t* b, uint64_t len,
                            uint64_t* ptr) {
  while (*x < kRansL && *ptr < len) *x = (*x << 8) | b[(*ptr)++];
}

inline void rans_renorm_enc(uint32_t* x, uint32_t f, Buf* rev) {
  uint32_t x_max = ((kRansL >> kTfShift) << 8) * f;
  while (*x >= x_max) {
    rev->putc((char)(*x & 0xFF));
    *x >>= 8;
  }
}

// Division-free encode symbol: q = x/f via a fixed-point reciprocal
// multiply and x' = x + bias + q*(4096-f) (== (x/f)<<12 + x%f + cum),
// exact for the renormalised state range x < 2^31.
// Provenance: this is the ryg_rans reciprocal method (Fabian Giesen's
// public-domain rans_static reference, "Alias method + reciprocal"
// formulation); any correct division-free rANS encoder converges to
// this shape, cited here so the similarity is deliberate, not silent.
struct RansEncSym {
  uint64_t rcp;
  uint32_t bias, cmpl, shift, x_max;
};

inline void rans_enc_sym_init(RansEncSym* s, uint32_t f, uint32_t cm) {
  s->x_max = ((kRansL >> kTfShift) << 8) * f;
  s->cmpl = kTotFreq - f;
  if (f < 2) {
    // f==1: q must degenerate to x-1, i.e. rcp = 2^32-1 so that
    // (x*(2^32-1))>>32 == x-1 for 1 <= x < 2^32; bias absorbs the
    // correction.  (f==0 symbols are never encoded; the init is safe.)
    s->rcp = 0xFFFFFFFFull;
    s->shift = 0;
    s->bias = cm + kTotFreq - 1;
  } else {
    uint32_t shift = 0;
    while (f > (1u << shift)) shift++;
    s->rcp = (uint64_t)((((unsigned __int128)1 << (shift + 31)) + f - 1) / f);
    s->shift = shift - 1;
    s->bias = cm;
  }
}

inline void rans_enc_put(uint32_t* xp, const RansEncSym* s, Buf* rev) {
  uint32_t x = *xp;
  while (x >= s->x_max) {
    rev->putc((char)(x & 0xFF));
    x >>= 8;
  }
  uint32_t q = (uint32_t)((((unsigned __int128)x * s->rcp) >> 32) >> s->shift);
  *xp = x + s->bias + q * s->cmpl;
}

}  // namespace

extern "C" {

// Decode one rANS 4x8 stream (with its 9-byte order/csize/usize header)
// into out (out_cap >= the header's uncompressed size).  Returns bytes
// written or -1 malformed.
int64_t htstpu_rans4x8_uncompress(const uint8_t* in, uint64_t in_len,
                                  uint8_t* out, uint64_t out_cap) {
  if (in_len < 9) return -1;
  int order = in[0];
  uint32_t out_sz;
  memcpy(&out_sz, in + 5, 4);
  if (out_sz > out_cap) return -1;
  if (out_sz == 0) return 0;
  uint64_t p = 9;
  if (order == 0) {
    uint32_t freqs[256];
    if (!rans_read_freqs(in, in_len, &p, freqs)) return -1;
    static thread_local RansTbl tbl;
    if (!tbl.build(freqs)) return -1;
    if (p + 16 > in_len) return -1;
    uint32_t x[4];
    memcpy(x, in + p, 16);
    p += 16;
    uint64_t ptr = p;
    uint64_t nmain = out_sz / 4;
    // fast main loop while >=8 renorm bytes remain: no per-byte bounds
    uint64_t safe_end = in_len >= 8 ? in_len - 8 : 0;
    uint64_t i = 0;
    uint32_t x0v = x[0], x1v = x[1], x2v = x[2], x3v = x[3];
    // One 8-byte load per iteration feeds every renorm: the 4 states can
    // consume at most 2 bytes each, so a register window breaks the
    // load->ptr->load dependency chain (the serial bottleneck: in[ptr]
    // depended on all previous states' increments).  Byte extraction is
    // a shift off `w`, leaving only the 1-cycle `used` accumulation on
    // the cross-state critical path.
    for (; i < nmain; i++) {
      if (ptr > safe_end) break;
      uint64_t w;
      memcpy(&w, in + ptr, 8);
      uint32_t used = 0;
      uint32_t ob = 0;
#define R4X8_STEP(xv, oi) do { \
        uint32_t m = (xv) & (kTotFreq - 1); \
        uint32_t e = tbl.ent[m]; \
        ob |= (uint32_t)(uint8_t)e << (8 * (oi)); \
        (xv) = (((e >> 8) & 0xFFF) + 1) * ((xv) >> kTfShift) + m \
               - (e >> 20); \
        uint32_t t1 = (xv) < kRansL; \
        uint32_t y1 = ((xv) << 8) | (uint32_t)((w >> (8 * used)) & 0xFF); \
        (xv) = t1 ? y1 : (xv); \
        used += t1; \
        uint32_t t2 = (xv) < kRansL; \
        uint32_t y2 = ((xv) << 8) | (uint32_t)((w >> (8 * used)) & 0xFF); \
        (xv) = t2 ? y2 : (xv); \
        used += t2; \
    } while (0)
      R4X8_STEP(x0v, 0);
      R4X8_STEP(x1v, 1);
      R4X8_STEP(x2v, 2);
      R4X8_STEP(x3v, 3);
#undef R4X8_STEP
      memcpy(out + i * 4, &ob, 4);
      ptr += used;
    }
    x[0] = x0v; x[1] = x1v; x[2] = x2v; x[3] = x3v;
    for (; i < nmain; i++) {
      for (int j = 0; j < 4; j++) {
        uint32_t m = x[j] & (kTotFreq - 1);
        uint32_t e = tbl.ent[m];
        out[i * 4 + j] = (uint8_t)e;
        x[j] = (((e >> 8) & 0xFFF) + 1) * (x[j] >> kTfShift) + m
               - (e >> 20);
        rans_renorm_dec(&x[j], in, in_len, &ptr);
      }
    }
    for (uint64_t k = nmain * 4; k < out_sz; k++) {
      int j = (int)(k - nmain * 4);
      uint32_t m = x[j] & (kTotFreq - 1);
      uint32_t e = tbl.ent[m];
      out[k] = (uint8_t)e;
      x[j] = (((e >> 8) & 0xFFF) + 1) * (x[j] >> kTfShift) + m - (e >> 20);
      rans_renorm_dec(&x[j], in, in_len, &ptr);
    }
    return out_sz;
  }
  if (order != 1) return -1;
  // order-1: 256-context table; build slot tables only for used contexts
  std::vector<uint32_t> freqs(256 * 256, 0);
  std::vector<uint16_t> cum(256 * 257, 0);
  std::vector<RansTbl> tbls;   // compact storage for used contexts
  int tidx[256];
  for (int i = 0; i < 256; i++) tidx[i] = -1;
  {
    if (p >= in_len) return -1;
    int sym = in[p++];
    int rle = 0;
    for (;;) {
      uint32_t inner[256];
      if (!rans_read_freqs(in, in_len, &p, inner)) return -1;
      memcpy(&freqs[sym * 256], inner, sizeof(inner));
      tidx[sym] = (int)tbls.size();
      tbls.emplace_back();
      if (!tbls.back().build(inner)) return -1;
      uint32_t c = 0;
      for (int s2 = 0; s2 < 256; s2++) {
        cum[sym * 257 + s2] = (uint16_t)c;
        c += inner[s2];
      }
      cum[sym * 257 + 256] = (uint16_t)std::min<uint32_t>(c, kTotFreq);
      if (rle == 0 && p < in_len && in[p] == sym + 1) {
        sym = in[p++];
        if (p >= in_len) return -1;
        rle = in[p++];
      } else if (rle > 0) {
        rle--;
        sym++;
        if (sym > 255) return -1;
      } else {
        if (p >= in_len) return -1;
        sym = in[p++];
      }
      if (sym == 0) break;
    }
  }
  if (p + 16 > in_len) return -1;
  uint32_t x[4];
  memcpy(x, in + p, 16);
  uint64_t ptr = p + 16;
  uint64_t isz4 = out_sz >> 2;
  uint32_t l[4] = {0, 0, 0, 0};
  uint64_t pos[4] = {0, isz4, 2 * isz4, 3 * isz4};
  for (uint64_t i = 0; i < isz4; i++) {
    for (int j = 0; j < 4; j++) {
      int ti = tidx[l[j]];
      if (ti < 0) return -1;  // context never declared: corrupt
      const RansTbl& t = tbls[ti];
      uint32_t m = x[j] & (kTotFreq - 1);
      uint32_t e = t.ent[m];
      uint8_t s = (uint8_t)e;
      out[pos[j]] = s;
      x[j] = (((e >> 8) & 0xFFF) + 1) * (x[j] >> kTfShift) + m - (e >> 20);
      if (ptr + 8 <= in_len) {      // branchless fast renorm
        uint32_t t1 = x[j] < kRansL;
        uint32_t y1 = (x[j] << 8) | in[ptr];
        x[j] = t1 ? y1 : x[j];
        ptr += t1;
        uint32_t t2 = x[j] < kRansL;
        uint32_t y2 = (x[j] << 8) | in[ptr];
        x[j] = t2 ? y2 : x[j];
        ptr += t2;
      } else {
        rans_renorm_dec(&x[j], in, in_len, &ptr);
      }
      l[j] = s;
      pos[j]++;
    }
  }
  for (uint64_t k = 4 * isz4; k < out_sz; k++) {
    int ti = tidx[l[3]];
    if (ti < 0) return -1;
    const RansTbl& t = tbls[ti];
    uint32_t m = x[3] & (kTotFreq - 1);
    uint8_t s = (uint8_t)t.ent[m];
    out[k] = s;
    {
      uint32_t e2 = t.ent[m];
      x[3] = (((e2 >> 8) & 0xFFF) + 1) * (x[3] >> kTfShift) + m
             - (e2 >> 20);
    }
    rans_renorm_dec(&x[3], in, in_len, &ptr);
    l[3] = s;
  }
  return out_sz;
}

// Encode with the given order (0/1).  Writes the full stream including the
// 9-byte header into *out_ptr (htstpu_buf_free to release); returns length
// or -1.
int64_t htstpu_rans4x8_compress(const uint8_t* in, uint64_t n, int order,
                                uint8_t** out_ptr) {
  Buf body;
  if (order == 0 || n < 4) {
    order = 0;
    uint64_t hist[256] = {0};
    for (uint64_t i = 0; i < n; i++) hist[in[i]]++;
    uint32_t freqs[256];
    if (!rans_normalize(hist, freqs)) return -1;
    uint32_t cum[257] = {0};
    for (int s = 0; s < 256; s++) cum[s + 1] = cum[s] + freqs[s];
    rans_write_freqs(&body, freqs);
    RansEncSym esym[256];
    for (int s = 0; s < 256; s++)
      rans_enc_sym_init(&esym[s], freqs[s], cum[s]);
    uint32_t x[4] = {kRansL, kRansL, kRansL, kRansL};
    Buf rev;
    for (int64_t i = (int64_t)n - 1; i >= 0; i--)
      rans_enc_put(&x[i & 3], &esym[in[i]], &rev);
    body.put(x, 16);
    body.reserve(rev.len());
    {
      uint8_t* w = body.end_ptr();
      const uint8_t* rd = rev.data() + rev.len();
      for (size_t i2 = 0; i2 < rev.len(); i2++) *w++ = *--rd;
      body.bump(rev.len());
    }
  } else {
    uint64_t isz4 = n >> 2;
    // context histograms (ctx = previous byte; 0 at each quarter start)
    std::vector<uint64_t> hist(256 * 256, 0);
    for (uint64_t i = 0; i < n; i++) {
      uint8_t c = (i == 0 || i == isz4 || i == 2 * isz4 || i == 3 * isz4)
                      ? 0 : in[i - 1];
      hist[(uint64_t)c * 256 + in[i]]++;
    }
    std::vector<uint32_t> freqs(256 * 256, 0);
    std::vector<uint32_t> cum(256 * 257, 0);
    uint8_t used[256];
    int nused = 0;
    for (int c = 0; c < 256; c++) {
      uint64_t s = 0;
      for (int k = 0; k < 256; k++) s += hist[c * 256 + k];
      if (!s) continue;
      used[nused++] = (uint8_t)c;
      if (!rans_normalize(&hist[c * 256], &freqs[c * 256])) return -1;
      for (int k = 0; k < 256; k++)
        cum[c * 257 + k + 1] = cum[c * 257 + k] + freqs[c * 256 + k];
    }
    // outer RLE of contexts, inner tables
    int i = 0;
    while (i < nused) {
      int run = 0;
      while (i + run + 1 < nused && used[i + run + 1] == used[i + run] + 1)
        run++;
      body.putc((char)used[i]);
      rans_write_freqs(&body, &freqs[used[i] * 256]);
      if (run >= 1) {
        body.putc((char)(used[i] + 1));
        body.putc((char)(run - 1));
        for (int j = 1; j <= run; j++)
          rans_write_freqs(&body, &freqs[used[i + j] * 256]);
        i += run + 1;
      } else {
        i++;
      }
    }
    body.putc('\0');
    // division-free symbol tables, densely packed over used contexts
    int ctx_idx[256];
    for (int c = 0; c < 256; c++) ctx_idx[c] = -1;
    for (int u = 0; u < nused; u++) ctx_idx[used[u]] = u;
    std::vector<RansEncSym> esym((size_t)nused * 256);
    for (int u = 0; u < nused; u++) {
      int c = used[u];
      for (int s = 0; s < 256; s++)
        rans_enc_sym_init(&esym[(size_t)u * 256 + s], freqs[c * 256 + s],
                          cum[c * 257 + s]);
    }
    // encode in exact reverse of the decoder's (round, state) consumption
    uint32_t x[4] = {kRansL, kRansL, kRansL, kRansL};
    uint64_t starts[4] = {0, isz4, 2 * isz4, 3 * isz4};
    Buf rev;
    auto enc1 = [&](int j, uint64_t pos) {
      uint8_t s = in[pos];
      uint8_t c = pos == starts[j] ? 0 : in[pos - 1];
      rans_enc_put(&x[j], &esym[(size_t)ctx_idx[c] * 256 + s], &rev);
    };
    for (int64_t k = (int64_t)n - 1; k >= (int64_t)(4 * isz4); k--)
      enc1(3, (uint64_t)k);
    for (int64_t i2 = (int64_t)isz4 - 1; i2 >= 0; i2--)
      for (int j = 3; j >= 0; j--) enc1(j, starts[j] + (uint64_t)i2);
    body.put(x, 16);
    body.reserve(rev.len());
    {
      uint8_t* w = body.end_ptr();
      const uint8_t* rd = rev.data() + rev.len();
      for (size_t i2 = 0; i2 < rev.len(); i2++) *w++ = *--rd;
      body.bump(rev.len());
    }
  }
  uint64_t blen = body.len();
  uint8_t* out = (uint8_t*)malloc(9 + blen);
  if (!out) return -1;
  out[0] = (uint8_t)order;
  uint32_t csz = (uint32_t)blen, usz = (uint32_t)n;
  memcpy(out + 1, &csz, 4);
  memcpy(out + 5, &usz, 4);
  memcpy(out + 9, body.data(), blen);
  *out_ptr = out;
  return 9 + (int64_t)blen;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native CRAM v3 slice decoder (cram/cram_decode.c:2346 cram_decode_slice).
//
// Mirrors htslib_tpu/cram/decode.py exactly for the common configurations:
// CRAM v3, single-ref/unmapped/no-ref slices, codecs EXTERNAL / HUFFMAN /
// BETA / GAMMA / SUBEXP / BYTE_ARRAY_LEN / BYTE_ARRAY_STOP.  On ANY
// uncertainty (unknown codec, v4 feature, suspicious offsets) it returns
// kBail and the Python implementation decodes the slice instead —
// correctness never depends on this fast path.  Output is a u32-framed BAM
// record stream rehydrated by BamRecord.from_bam_buffer.
// ---------------------------------------------------------------------------

namespace cramdec {

constexpr int64_t kBail = -100;
constexpr int64_t kI64Min = INT64_MIN;

// encoding ids (cram_structs.h / structs.py)
enum {
  E_NULL = 0, E_EXTERNAL = 1, E_HUFFMAN = 3, E_BYTE_ARRAY_LEN = 4,
  E_BYTE_ARRAY_STOP = 5, E_BETA = 6, E_SUBEXP = 7, E_GAMMA = 9,
};
// cram record flags (structs.py:44-52)
enum {
  CF_PRESERVE_QUAL = 0x1, CF_DETACHED = 0x2, CF_MATE_DOWNSTREAM = 0x4,
  CF_NO_SEQ = 0x8, CF_EXPLICIT_TLEN = 0x10,
  M_REVERSE = 1, M_UNMAP = 2,
};
// BAM flags
enum {
  FPAIRED = 0x1, FUNMAP = 0x4, FMUNMAP = 0x8, FREVERSE = 0x10,
  FMREVERSE = 0x20, FREAD1 = 0x40,
};
// cigar ops
enum { CMATCH = 0, CINS = 1, CDEL = 2, CREF_SKIP = 3, CSOFT = 4,
       CHARD = 5, CPAD = 6 };

struct BitR {
  const uint8_t* d = nullptr;
  uint64_t len = 0, byte = 0;
  int bit = 7;
  bool fail = false;
  inline int get_bit() {
    if (byte >= len) { fail = true; return 0; }
    int b = (d[byte] >> bit) & 1;
    if (bit == 0) { bit = 7; byte++; } else bit--;
    return b;
  }
  inline uint32_t get_bits(int n) {
    uint32_t v = 0;
    while (n-- > 0) v = (v << 1) | (uint32_t)get_bit();
    return v;
  }
};

struct Ext {
  const uint8_t* d = nullptr;
  uint64_t len = 0, pos = 0;
};

struct Ctx;  // fwd

struct Codec {
  int id = E_NULL;
  int content_id = -1;
  int stop = 0;
  int64_t offset = 0;
  int nbits = 0, k = 0;
  // canonical huffman: entries sorted by (len, sym)
  std::vector<int> hlen;
  std::vector<uint32_t> hcode;
  std::vector<int64_t> hsym;
  bool has_const = false;
  int64_t const_val = 0;
  int32_t by_len_code[33];
  int32_t by_len_idx[33];
  Codec* sub0 = nullptr;  // BYTE_ARRAY_LEN: len codec
  Codec* sub1 = nullptr;  //                value codec
};

struct Ctx {
  BitR core;
  std::unordered_map<int, Ext> ext;
  bool fail = false;  // any error/unsupported -> bail
  Ext* get(int cid) {
    auto it = ext.find(cid);
    if (it == ext.end()) { fail = true; return nullptr; }
    return &it->second;
  }
};

int64_t codec_read_int(const Codec* c, Ctx* x);

int codec_read_byte(const Codec* c, Ctx* x) {
  if (c->id == E_EXTERNAL) {
    Ext* s = x->get(c->content_id);
    if (!s || s->pos >= s->len) { x->fail = true; return 0; }
    return s->d[s->pos++];
  }
  return (int)(uint8_t)codec_read_int(c, x);
}

int64_t codec_read_int(const Codec* c, Ctx* x) {
  switch (c->id) {
    case E_EXTERNAL: {
      Ext* s = x->get(c->content_id);
      if (!s) return 0;
      uint32_t v;
      uint64_t p = s->pos;
      if (!itf8_get(s->d, s->len, &p, &v)) { x->fail = true; return 0; }
      s->pos = p;
      return (int32_t)v;  // ITF8 is a 32-bit signed int
    }
    case E_HUFFMAN: {
      if (c->has_const) return c->const_val;
      uint32_t val = 0;
      for (int length = 1; length <= 31; length++) {
        val = (val << 1) | (uint32_t)x->core.get_bit();
        if (x->core.fail) { x->fail = true; return 0; }
        int32_t fc = c->by_len_code[length];
        if (fc >= 0 && val >= (uint32_t)fc) {
          size_t idx = (size_t)c->by_len_idx[length] + (val - (uint32_t)fc);
          if (idx < c->hlen.size() && c->hlen[idx] == length)
            return c->hsym[idx];
        }
      }
      x->fail = true;
      return 0;
    }
    case E_BETA: {
      int64_t v = (int64_t)x->core.get_bits(c->nbits) - c->offset;
      if (x->core.fail) x->fail = true;
      return v;
    }
    case E_GAMMA: {
      int nz = 0;
      while (!x->core.fail && x->core.get_bit() == 0) {
        if (++nz > 40) { x->fail = true; return 0; }
      }
      int64_t val = 1;
      for (int i = 0; i < nz; i++) val = (val << 1) | x->core.get_bit();
      if (x->core.fail) x->fail = true;
      return val - 1 - c->offset;
    }
    case E_SUBEXP: {
      int i = 0;
      while (!x->core.fail && x->core.get_bit() == 1) {
        if (++i > 40) { x->fail = true; return 0; }
      }
      int64_t n;
      if (i == 0) n = x->core.get_bits(c->k);
      else {
        int b = i + c->k - 1;
        if (b > 31) { x->fail = true; return 0; }
        n = (1ll << b) | x->core.get_bits(b);
      }
      if (x->core.fail) x->fail = true;
      return n - c->offset;
    }
    default:
      x->fail = true;
      return 0;
  }
}

// exactly n bytes (seq fragments of known length)
void codec_read_bytes(const Codec* c, Ctx* x, uint64_t n, Buf* out);

// length-prefixed / stop-terminated byte array (names, tags, SC/IN/BB)
bool codec_read_array(const Codec* c, Ctx* x, Buf* out) {
  if (c->id == E_BYTE_ARRAY_LEN) {
    int64_t n = codec_read_int(c->sub0, x);
    if (x->fail || n < 0 || n > (1 << 28)) { x->fail = true; return false; }
    codec_read_bytes(c->sub1, x, (uint64_t)n, out);
    return !x->fail;
  }
  if (c->id == E_BYTE_ARRAY_STOP) {
    Ext* s = x->get(c->content_id);
    if (!s) return false;
    const uint8_t* e = (const uint8_t*)memchr(s->d + s->pos, c->stop,
                                              s->len - s->pos);
    if (!e) {  // htslib tolerates a missing stop byte at end of block
      out->put(s->d + s->pos, s->len - s->pos);
      s->pos = s->len;
      return true;
    }
    out->put(s->d + s->pos, (uint64_t)(e - (s->d + s->pos)));
    s->pos = (uint64_t)(e - s->d) + 1;
    return true;
  }
  x->fail = true;
  return false;
}

void codec_read_bytes(const Codec* c, Ctx* x, uint64_t n, Buf* out) {
  if (c->id == E_EXTERNAL) {
    Ext* s = x->get(c->content_id);
    if (!s) return;
    if (s->pos + n > s->len) { x->fail = true; return; }
    out->put(s->d + s->pos, n);
    s->pos += n;
    return;
  }
  if (c->id == E_BYTE_ARRAY_LEN || c->id == E_BYTE_ARRAY_STOP) {
    // fixed-length reads still honour the stored length (codecs.py:455)
    codec_read_array(c, x, out);
    return;
  }
  for (uint64_t i = 0; i < n && !x->fail; i++)
    out->putc((char)codec_read_byte(c, x));
}

// ---- compression header ----------------------------------------------------

struct CompHdr {
  bool read_names_included = true;
  bool AP_delta = true;
  bool no_ref = false;
  bool qs_seq_orient = true;
  uint8_t sub_matrix[5][4];
  std::vector<std::string> TD;
  std::unordered_map<uint32_t, Codec*> codecs;      // 2-char key packed
  std::unordered_map<uint32_t, Codec*> tag_codecs;  // kid
  std::vector<std::unique_ptr<Codec>> arena;
};

inline uint32_t skey(const char* k) {
  return ((uint32_t)(uint8_t)k[0] << 8) | (uint8_t)k[1];
}

Codec* parse_encoding(CompHdr* h, const uint8_t* b, uint64_t len, uint64_t* pp,
                      bool* ok) {
  uint32_t cid, nbytes;
  if (!itf8_get(b, len, pp, &cid) || !itf8_get(b, len, pp, &nbytes)) {
    *ok = false;
    return nullptr;
  }
  uint64_t end = *pp + nbytes;
  if (end > len) { *ok = false; return nullptr; }
  h->arena.emplace_back(new Codec());
  Codec* c = h->arena.back().get();
  c->id = (int)cid;
  switch (cid) {
    case E_NULL:
      break;
    case E_EXTERNAL: {
      uint32_t v;
      if (!itf8_get(b, len, pp, &v)) { *ok = false; return nullptr; }
      c->content_id = (int)v;
      break;
    }
    case E_HUFFMAN: {
      uint32_t nsym;
      if (!itf8_get(b, len, pp, &nsym) || nsym > 65536) { *ok = false; return nullptr; }
      std::vector<int64_t> syms(nsym);
      for (uint32_t i = 0; i < nsym; i++) {
        uint32_t v;
        if (!itf8_get(b, len, pp, &v)) { *ok = false; return nullptr; }
        syms[i] = (int32_t)v;
      }
      uint32_t nlen;
      if (!itf8_get(b, len, pp, &nlen) || nlen != nsym) { *ok = false; return nullptr; }
      std::vector<std::pair<int, int64_t>> zipped(nsym);
      for (uint32_t i = 0; i < nsym; i++) {
        uint32_t v;
        if (!itf8_get(b, len, pp, &v) || v > 31) { *ok = false; return nullptr; }
        zipped[i] = {(int)v, syms[i]};
      }
      std::sort(zipped.begin(), zipped.end());
      c->hlen.resize(nsym);
      c->hcode.resize(nsym);
      c->hsym.resize(nsym);
      int64_t val = -1;
      int last_len = 0;
      for (int i = 0; i < 33; i++) { c->by_len_code[i] = -1; c->by_len_idx[i] = -1; }
      for (uint32_t i = 0; i < nsym; i++) {
        int ln = zipped[i].first;
        val += 1;
        if (ln > last_len) { val <<= (ln - last_len); last_len = ln; }
        c->hlen[i] = ln;
        c->hcode[i] = (uint32_t)val;
        c->hsym[i] = zipped[i].second;
        if (c->by_len_code[ln] < 0) {
          c->by_len_code[ln] = (int32_t)val;
          c->by_len_idx[ln] = (int32_t)i;
        }
      }
      if (nsym == 1 && zipped[0].first == 0) {
        c->has_const = true;
        c->const_val = zipped[0].second;
      }
      break;
    }
    case E_BYTE_ARRAY_LEN: {
      c->sub0 = parse_encoding(h, b, len, pp, ok);
      c->sub1 = parse_encoding(h, b, len, pp, ok);
      if (!*ok) return nullptr;
      break;
    }
    case E_BYTE_ARRAY_STOP: {
      if (*pp >= len) { *ok = false; return nullptr; }
      c->stop = b[(*pp)++];
      uint32_t v;
      if (!itf8_get(b, len, pp, &v)) { *ok = false; return nullptr; }
      c->content_id = (int)v;
      break;
    }
    case E_BETA: {
      uint32_t off, nb;
      if (!itf8_get(b, len, pp, &off) || !itf8_get(b, len, pp, &nb) || nb > 32) {
        *ok = false;
        return nullptr;
      }
      c->offset = (int32_t)off;
      c->nbits = (int)nb;
      break;
    }
    case E_SUBEXP: {
      uint32_t off, k;
      if (!itf8_get(b, len, pp, &off) || !itf8_get(b, len, pp, &k) || k > 31) {
        *ok = false;
        return nullptr;
      }
      c->offset = (int32_t)off;
      c->k = (int)k;
      break;
    }
    case E_GAMMA: {
      uint32_t off;
      if (!itf8_get(b, len, pp, &off)) { *ok = false; return nullptr; }
      c->offset = (int32_t)off;
      break;
    }
    default:
      *ok = false;  // GOLOMB / v4 / transform codecs: python path
      return nullptr;
  }
  *pp = end;
  return c;
}

bool parse_comp_hdr(CompHdr* h, const uint8_t* b, uint64_t len) {
  // default substitution matrix "CGTN AGTN ACTN ACGN ACGT"
  static const char* kDefault[5] = {"CGTN", "AGTN", "ACTN", "ACGN", "ACGT"};
  for (int i = 0; i < 5; i++) memcpy(h->sub_matrix[i], kDefault[i], 4);
  uint64_t p = 0;
  uint32_t tmp, n;
  if (!itf8_get(b, len, &p, &tmp) || !itf8_get(b, len, &p, &n)) return false;
  for (uint32_t i = 0; i < n; i++) {
    if (p + 2 > len) return false;
    char k0 = (char)b[p], k1 = (char)b[p + 1];
    p += 2;
    auto is1 = [&](const char* s) { return k0 == s[0] && k1 == s[1]; };
    if (is1("MI") || is1("UI") || is1("PI") || is1("RN") || is1("AP") ||
        is1("RR") || is1("QO")) {
      if (p >= len) return false;
      uint8_t v = b[p++];
      if (is1("RN")) h->read_names_included = v != 0;
      else if (is1("AP")) h->AP_delta = v != 0;
      else if (is1("RR")) h->no_ref = v == 0;
      else if (is1("QO")) h->qs_seq_orient = v != 0;
    } else if (is1("SM")) {
      if (p + 5 > len) return false;
      static const char* kBases = "ACGTN";
      for (int i2 = 0; i2 < 5; i2++) {
        char others[4];
        int oi = 0;
        for (int j = 0; j < 5; j++)
          if (j != i2) others[oi++] = kBases[j];
        for (int j = 0; j < 4; j++) {
          int code = (b[p + i2] >> (6 - 2 * j)) & 3;
          h->sub_matrix[i2][code] = (uint8_t)others[j];
        }
      }
      p += 5;
    } else if (is1("TD")) {
      uint32_t ln;
      if (!itf8_get(b, len, &p, &ln) || p + ln > len) return false;
      // split on NUL; trailing NUL drops the empty tail (decode.py:171)
      uint64_t s = p, e = p + ln;
      while (s < e) {
        const uint8_t* z = (const uint8_t*)memchr(b + s, 0, e - s);
        uint64_t stop = z ? (uint64_t)(z - b) : e;
        h->TD.emplace_back((const char*)b + s, stop - s);
        s = z ? stop + 1 : e;
      }
      if (ln == 0 || b[e - 1] != 0) {
        // blob without trailing NUL keeps its last element (split keeps it)
        if (ln == 0) h->TD.emplace_back("");
      }
      p = e;
    } else {
      return false;  // unknown preservation key: python path
    }
  }
  bool ok = true;
  if (!itf8_get(b, len, &p, &tmp) || !itf8_get(b, len, &p, &n)) return false;
  for (uint32_t i = 0; i < n; i++) {
    if (p + 2 > len) return false;
    uint32_t key = skey((const char*)b + p);
    p += 2;
    Codec* c = parse_encoding(h, b, len, &p, &ok);
    if (!ok) return false;
    h->codecs[key] = c;
  }
  if (!itf8_get(b, len, &p, &tmp) || !itf8_get(b, len, &p, &n)) return false;
  for (uint32_t i = 0; i < n; i++) {
    uint32_t kid;
    if (!itf8_get(b, len, &p, &kid)) return false;
    Codec* c = parse_encoding(h, b, len, &p, &ok);
    if (!ok) return false;
    h->tag_codecs[kid] = c;
  }
  return true;
}

}  // namespace cramdec

namespace cramdec {

struct RecTmp {
  int64_t flags = 0, cram_flags = 0;
  int32_t ref_id = -1;
  int64_t len = 0, apos = 0;
  int64_t rg = -1;
  int64_t mate_flags = 0;
  int32_t mate_ref_id = -1;
  int64_t mate_pos = 0;
  int64_t tlen = kI64Min, explicit_tlen = kI64Min;
  int64_t mate_line = -1;
  int64_t mqual = 0;
  int64_t aend = 0;
  // variable-length fields live in slice-level arenas (DecState) — one
  // record used to carry 4 heap strings + a vector, i.e. millions of
  // mallocs per file; now each is an (offset, length) view
  uint32_t name_off = 0, name_len = 0;
  uint32_t aux_off = 0, aux_len = 0;
  uint32_t seq_off = 0, seq_len = 0;
  uint32_t qual_off = 0, qual_len = 0;
  uint32_t cig_off = 0, cig_cnt = 0;
};

struct SliceArgs {
  int32_t ref_seq_id;
  int64_t ref_seq_start, ref_seq_span;
  int32_t num_records;
  int64_t record_counter;
  const uint8_t* ref;       // slice reference window (may be null)
  uint64_t ref_window_len;
  int64_t ref_start;        // 1-based genome coord of ref[0]
  int64_t ref_chrom_len;    // full chromosome length (0 = unknown)
  int32_t n_rg;
  int32_t decode_md;
};

struct DecState {
  const CompHdr* h = nullptr;
  Ctx* x = nullptr;
  const SliceArgs* a = nullptr;
  bool bail = false;
  // slice-lifetime scratch, reused across records: the per-record decode
  // used to malloc/free these millions of times per file (htslib reuses
  // its bam1_t/block buffers the same way)
  Buf tmp;
  std::string seq, qual, md, frag;
  // arenas backing every RecTmp variable-length field
  Buf names, auxs, seqs, quals;
  std::vector<uint32_t> cigs;
  Codec* get(uint32_t key) {
    auto it = h->codecs.find(key);
    return it == h->codecs.end() ? nullptr : it->second;
  }
  Codec* need(uint32_t key) {
    Codec* c = get(key);
    if (!c) bail = true;
    return c;
  }
};

#define K(a, b) ((uint32_t)(((uint8_t)(a) << 8) | (uint8_t)(b)))

inline int l1_of(uint8_t base) {
  switch (base) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return 4;
  }
}

// _decode_aux (decode.py:429): returns false on bail; has_MD/has_NM out.
// Appends the record's aux blob to the st->auxs arena (cr->aux_off/len).
bool decode_aux(DecState* st, RecTmp* cr, int* has_MD, int* has_NM) {
  *has_MD = *has_NM = 0;
  Buf& aux = st->auxs;
  cr->aux_off = (uint32_t)aux.len();
  Codec* TLc = st->get(K('T', 'L'));
  if (!TLc) return true;
  int64_t TL = codec_read_int(TLc, st->x);
  if (st->x->fail || TL < 0 || (size_t)TL >= st->h->TD.size()) return false;
  const std::string& TN = st->h->TD[(size_t)TL];
  for (size_t i = 0; i + 3 <= TN.size(); i += 3) {
    const char* tag = TN.data() + i;
    if (tag[2] == '*') return false;  // CRAM 4 placeholders: python path
    if (tag[0] == 'M' && tag[1] == 'D') *has_MD = 1;
    else if (tag[0] == 'N' && tag[1] == 'M') *has_NM = 1;
    uint32_t kid = ((uint32_t)(uint8_t)tag[0] << 16) |
                   ((uint32_t)(uint8_t)tag[1] << 8) | (uint8_t)tag[2];
    auto it = st->h->tag_codecs.find(kid);
    if (it == st->h->tag_codecs.end()) return false;
    Codec* c = it->second;
    size_t tag_at = aux.len();
    aux.put(tag, 3);
    if (c->id == E_BYTE_ARRAY_LEN || c->id == E_BYTE_ARRAY_STOP) {
      if (!codec_read_array(c, st->x, &aux)) return false;
    } else {
      int sz;
      switch (tag[2]) {
        case 'A': case 'c': case 'C': sz = 1; break;
        case 's': case 'S': sz = 2; break;
        case 'i': case 'I': case 'f': sz = 4; break;
        case 'd': sz = 8; break;
        default: return false;
      }
      codec_read_bytes(c, st->x, (uint64_t)sz, &aux);
      if (st->x->fail) return false;
    }
    if (tag[0] == 'c' && tag[1] == 'F' && aux.len() == tag_at + 4)
      aux.set_len(tag_at);  // cF control tag is consumed, not emitted
  }
  if (TN.size() % 3) return false;
  cr->aux_len = (uint32_t)(aux.len() - cr->aux_off);
  return true;
}

// _decode_seq (decode.py:486): feature playback + MD/NM generation.
bool decode_seq(DecState* st, RecTmp* cr, int cf, int has_MD, int has_NM) {
  const CompHdr* h = st->h;
  const SliceArgs* a = st->a;
  Ctx* x = st->x;
  if (cr->len < 0 || cr->len > (1 << 28)) return false;
  std::string& seq = st->seq;
  std::string& qual = st->qual;
  seq.assign((size_t)cr->len, a->ref ? '\0' : '=');
  qual.assign((size_t)cr->len, (char)0xFF);
  int64_t ref_len = a->ref_chrom_len;

  bool gen_md = ((a->decode_md && !has_MD) || has_MD < 0) && a->ref &&
                cr->ref_id >= 0 && !(cr->cram_flags & CF_NO_SEQ);
  bool gen_nm = ((a->decode_md && !has_NM) || has_NM < 0) && a->ref &&
                cr->ref_id >= 0 && !(cr->cram_flags & CF_NO_SEQ);
  std::string& md = st->md;
  md.clear();
  int64_t md_dist = 0;
  int64_t nm = 0;
  char numbuf[24];
  auto md_num = [&](int64_t v) {
    int n2 = snprintf(numbuf, sizeof numbuf, "%lld", (long long)v);
    md.append(numbuf, n2);
  };

  // ref bases [rp, rp+ln) in 0-based genome coords, padded with 'N'
  // (decode.py ref_at); negative window offsets bail (python would wrap)
  auto ref_at = [&](int64_t rp, int64_t ln, std::string* out2) -> bool {
    int64_t s = rp - (a->ref_start - 1);
    if (s < 0 || ln < 0) return false;
    int64_t have = (int64_t)a->ref_window_len - s;
    if (have < 0) have = 0;
    int64_t take = std::min(have, ln);
    out2->assign((const char*)a->ref + s, (size_t)take);
    out2->append((size_t)(ln - take), 'N');
    return true;
  };
  auto md_char = [&](uint8_t ch) {
    if (md_dist >= 0 && gen_md) {
      md_num(md_dist);
      md.push_back((char)ch);
    }
    md_dist = 0;
  };
  auto md_match_frag = [&](const std::string& frag) {
    if (!(gen_md || gen_nm) || md_dist < 0) return;
    for (unsigned char ch : frag) {
      if (ch == 'N') { md_char(ch); nm++; }
      else md_dist++;
    }
  };

  Codec* FNc = st->get(K('F', 'N'));
  int64_t fn = FNc ? codec_read_int(FNc, x) : 0;
  if (x->fail || fn < 0 || fn > (1 << 24)) return false;
  std::vector<uint32_t>& cigar = st->cigs;
  cr->cig_off = (uint32_t)cigar.size();
  int cig_op = CMATCH;
  int64_t cig_len = 0;
  int64_t seq_pos = 1;
  int64_t ref_pos = cr->apos - 1;
  int64_t prev_pos = 0;
  auto flush = [&](int op) {
    if (cig_len && cig_op != op) {
      cigar.push_back(((uint32_t)cig_len << 4) | (uint32_t)cig_op);
      cig_len = 0;
    }
    cig_op = op;
  };
  Codec* FCc = st->get(K('F', 'C'));
  Codec* FPc = st->get(K('F', 'P'));
  std::string& frag = st->frag;

  for (int64_t f = 0; f < fn; f++) {
    int op = FCc ? codec_read_byte(FCc, x) : 'B';
    int64_t pos = (FPc ? codec_read_int(FPc, x) : 0) + prev_pos;
    if (x->fail) return false;
    if (pos <= 0) return false;
    if (pos > seq_pos) {
      if (a->ref && cr->ref_id >= 0) {
        if (!ref_at(ref_pos, pos - seq_pos, &frag)) return false;
        if (ref_len && ref_pos + pos - seq_pos > ref_len) {
          int64_t avail = std::max<int64_t>(ref_len - ref_pos, 0);
          frag.resize((size_t)avail);
          frag.append((size_t)(pos - seq_pos - avail), 'N');
          if (md_dist >= 0) md_dist += pos - seq_pos;
        } else {
          md_match_frag(frag);
        }
        if (cr->len) {
          if ((uint64_t)(pos - 1) > seq.size()) return false;
          seq.replace((size_t)(seq_pos - 1), frag.size(), frag);
        }
      }
      flush(CMATCH);
      cig_len += pos - seq_pos;
      ref_pos += pos - seq_pos;
      seq_pos = pos;
    }
    prev_pos = pos;

    switch (op) {
      case 'S': {
        flush(CSOFT);
        Codec* c = st->get(K('S', 'C'));
        if (c) {
          Buf& data = st->tmp;
          data.clear();
          if (!codec_read_array(c, x, &data)) return false;
          if (cr->len) {
            if ((uint64_t)(pos - 1) + data.len() > seq.size()) return false;
            seq.replace((size_t)(pos - 1), data.len(),
                        (const char*)data.data(), data.len());
          }
          cigar.push_back(((uint32_t)data.len() << 4) | CSOFT);
          cig_op = CSOFT;
          cig_len = 0;
          seq_pos += (int64_t)data.len();
        }
        break;
      }
      case 'X': {
        flush(CMATCH);
        Codec* c = st->get(K('B', 'S'));
        if (c) {
          int code = codec_read_byte(c, x);
          if (x->fail || code < 0 || code > 3) return false;
          const uint8_t* base_row;
          if (cr->ref_id < 0 || !a->ref ||
              (ref_len && ref_pos >= ref_len)) {
            base_row = h->sub_matrix[4];
            if (md_dist >= 0 && gen_md) md_num(md_dist);
            md_dist = -1;
          } else {
            if (!ref_at(ref_pos, 1, &frag)) return false;
            uint8_t rc = frag.empty() ? 'N' : (uint8_t)frag[0];
            base_row = h->sub_matrix[l1_of(rc)];
            md_char(rc);
            nm++;
          }
          if (pos - 1 < cr->len) seq[(size_t)(pos - 1)] = (char)base_row[code];
        }
        cig_len++;
        seq_pos++;
        ref_pos++;
        break;
      }
      case 'D': {
        flush(CDEL);
        Codec* c = st->get(K('D', 'L'));
        int64_t n2 = c ? codec_read_int(c, x) : 0;
        if (x->fail || n2 < 0 || n2 > (1 << 28)) return false;
        if ((gen_md || gen_nm) && n2) {
          if (md_dist >= 0 && gen_md) md_num(md_dist);
          if (!ref_len || ref_pos + n2 <= ref_len) {
            if (gen_md) {
              if (!ref_at(ref_pos, n2, &frag)) return false;
              md.push_back('^');
              md += frag;
              md_dist = 0;
            }
            nm += n2;
          } else {
            int64_t avail = std::max<int64_t>(ref_len - ref_pos, 0);
            if (gen_md && avail > 0) {
              if (!ref_at(ref_pos, avail, &frag)) return false;
              md.push_back('^');
              md += frag;
              md.push_back('0');
              nm += avail;
            }
            md_dist = -1;
          }
        }
        cig_len += n2;
        ref_pos += n2;
        break;
      }
      case 'I': {
        flush(CINS);
        Codec* c = st->get(K('I', 'N'));
        if (c) {
          Buf& data = st->tmp;
          data.clear();
          if (!codec_read_array(c, x, &data)) return false;
          if (cr->len) {
            if ((uint64_t)(pos - 1) + data.len() > seq.size()) return false;
            seq.replace((size_t)(pos - 1), data.len(),
                        (const char*)data.data(), data.len());
          }
          cig_len += (int64_t)data.len();
          seq_pos += (int64_t)data.len();
          nm += (int64_t)data.len();
        }
        break;
      }
      case 'i': {
        flush(CINS);
        Codec* c = st->get(K('B', 'A'));
        if (c) {
          int b2 = codec_read_byte(c, x);
          if (x->fail) return false;
          if (cr->len) {
            if (pos - 1 >= cr->len) return false;
            seq[(size_t)(pos - 1)] = (char)b2;
          }
        }
        cig_len++;
        seq_pos++;
        nm++;
        break;
      }
      case 'b': {
        flush(CMATCH);
        int64_t n2 = cr->len ? cr->len - (pos - 1) : 1;
        Codec* c = st->get(K('B', 'B'));
        if (c) {
          Buf& data = st->tmp;
          data.clear();
          if (!codec_read_array(c, x, &data)) return false;
          n2 = (int64_t)data.len();
          if (cr->len) {
            if ((uint64_t)(pos - 1) + data.len() > seq.size()) return false;
            seq.replace((size_t)(pos - 1), data.len(),
                        (const char*)data.data(), data.len());
          }
          if (gen_md || gen_nm) {
            // every stored base treated as a mismatch (cram_decode.c:1505)
            if (md_dist >= 0 && gen_md) md_num(md_dist);
            int64_t x2 = 0;
            bool broke = false;
            for (x2 = 0; x2 < n2; x2++) {
              if (x2 && gen_md) md.push_back('0');
              if ((ref_len && ref_pos + x2 >= ref_len) || !a->ref) {
                md_dist = -1;
                broke = true;
                break;
              }
              if (gen_md) {
                if (!ref_at(ref_pos + x2, 1, &frag)) return false;
                md += frag;
              }
            }
            if (!broke) x2 = n2;
            nm += x2;
            md_dist = 0;
          }
        }
        cig_len += n2;
        seq_pos += n2;
        ref_pos += n2;
        break;
      }
      case 'q': {
        flush(CMATCH);
        Codec* c = st->get(K('Q', 'Q'));
        if (c) {
          Buf& data = st->tmp;
          data.clear();
          if (!codec_read_array(c, x, &data)) return false;
          if (cr->len) {
            if ((uint64_t)(pos - 1) + data.len() > qual.size()) return false;
            qual.replace((size_t)(pos - 1), data.len(),
                         (const char*)data.data(), data.len());
          }
        }
        break;
      }
      case 'B': {
        flush(CMATCH);
        Codec* c = st->get(K('B', 'A'));
        if (c) {
          int b2 = codec_read_byte(c, x);
          if (x->fail) return false;
          if (cr->len) {
            if (pos - 1 >= cr->len) return false;
            seq[(size_t)(pos - 1)] = (char)b2;
          }
          if (gen_md || gen_nm) {
            if (md_dist >= 0 && gen_md) md_num(md_dist);
            if ((ref_len && ref_pos >= ref_len) || !a->ref) {
              md_dist = -1;
            } else {
              if (gen_md) {
                if (!ref_at(ref_pos, 1, &frag)) return false;
                md += frag;
              }
              nm++;
              md_dist = 0;
            }
          }
        }
        Codec* qs = st->get(K('Q', 'S'));
        if (qs) {
          int q = codec_read_byte(qs, x);
          if (x->fail) return false;
          if (!(cf & CF_PRESERVE_QUAL) && cr->len > 0 &&
              (uint8_t)qual[0] == 0xFF)
            qual.assign((size_t)cr->len, (char)0x1e);
          if (cr->len) {
            if (pos - 1 >= cr->len) return false;
            qual[(size_t)(pos - 1)] = (char)q;
          }
        }
        cig_len++;
        seq_pos++;
        ref_pos++;
        break;
      }
      case 'Q': {
        Codec* qs = st->get(K('Q', 'S'));
        if (qs) {
          int q = codec_read_byte(qs, x);
          if (x->fail) return false;
          if (!(cf & CF_PRESERVE_QUAL) && cr->len > 0 &&
              (uint8_t)qual[0] == 0xFF)
            qual.assign((size_t)cr->len, (char)0x1e);
          if (cr->len) {
            if (pos - 1 >= cr->len) return false;
            qual[(size_t)(pos - 1)] = (char)q;
          }
        }
        break;
      }
      case 'H': {
        flush(CHARD);
        Codec* c = st->get(K('H', 'C'));
        if (c) {
          int64_t n2 = codec_read_int(c, x);
          if (x->fail || n2 < 0) return false;
          cig_len += n2;
        }
        break;
      }
      case 'P': {
        flush(CPAD);
        Codec* c = st->get(K('P', 'D'));
        if (c) {
          int64_t n2 = codec_read_int(c, x);
          if (x->fail || n2 < 0) return false;
          cig_len += n2;
        }
        break;
      }
      case 'N': {
        flush(CREF_SKIP);
        Codec* c = st->get(K('R', 'S'));
        if (c) {
          int64_t n2 = codec_read_int(c, x);
          if (x->fail || n2 < 0) return false;
          cig_len += n2;
          ref_pos += n2;
        }
        break;
      }
      default:
        return false;
    }
  }

  // implicit trailing match
  if (cr->len >= seq_pos) {
    if (a->ref && cr->ref_id >= 0) {
      int64_t remainder = cr->len - seq_pos + 1;
      if (!ref_at(ref_pos, remainder, &frag)) return false;
      if (ref_len && ref_pos + remainder > ref_len) {
        int64_t avail = std::max<int64_t>(ref_len - ref_pos, 0);
        frag.resize((size_t)avail);
        frag.append((size_t)(remainder - avail), 'N');
        if (md_dist >= 0) md_dist += remainder;
      } else {
        md_match_frag(frag);
      }
      seq.replace((size_t)(seq_pos - 1), frag.size(), frag);
      ref_pos += remainder;
    } else if (cr->ref_id >= 0) {
      ref_pos += cr->len - seq_pos + 1;
    }
    flush(CMATCH);
    cig_len += cr->len - seq_pos + 1;
  }
  if (gen_md && md_dist >= 0) md_num(md_dist);
  if (cig_len)
    cigar.push_back(((uint32_t)cig_len << 4) | (uint32_t)cig_op);
  cr->cig_cnt = (uint32_t)(cigar.size() - cr->cig_off);
  cr->aend = std::max(ref_pos, cr->apos);
  Codec* mq = st->get(K('M', 'Q'));
  cr->mqual = mq ? codec_read_int(mq, x) : 40;
  if (x->fail) return false;
  if ((cf & CF_PRESERVE_QUAL)) {
    Codec* qs = st->get(K('Q', 'S'));
    if (qs) {
      Buf& qb = st->tmp;
      qb.clear();
      codec_read_bytes(qs, x, (uint64_t)cr->len, &qb);
      if (x->fail) return false;
      qual.assign((const char*)qb.data(), qb.len());
    }
  }
  if (cr->cram_flags & CF_NO_SEQ) {
    cr->len = 0;
    seq.clear();
    qual.clear();
  }
  cr->seq_off = (uint32_t)st->seqs.len();
  cr->seq_len = (uint32_t)seq.size();
  st->seqs.put(seq.data(), seq.size());
  cr->qual_off = (uint32_t)st->quals.len();
  cr->qual_len = (uint32_t)qual.size();
  st->quals.put(qual.data(), qual.size());
  // MD/NM extend this record's aux blob: nothing has appended to the
  // arena since decode_aux, so the blob stays contiguous
  if (gen_md) {
    st->auxs.put("MDZ", 3);
    st->auxs.put(md.data(), md.size());
    st->auxs.putc('\0');
  }
  if (gen_nm) {
    if (nm < 0) return false;
    if (nm <= 0xFF) {
      st->auxs.put("NMC", 3);
      st->auxs.putc((char)(uint8_t)nm);
    } else if (nm <= 0xFFFF) {
      st->auxs.put("NMS", 3);
      uint16_t v = (uint16_t)nm;
      st->auxs.put(&v, 2);
    } else {
      st->auxs.put("NMI", 3);
      uint32_t v = (uint32_t)nm;
      st->auxs.put(&v, 4);
    }
  }
  cr->aux_len = (uint32_t)(st->auxs.len() - cr->aux_off);
  return true;
}

// _slice_xref (decode.py:775)
bool slice_xref(std::vector<RecTmp>& recs) {
  int64_t n = (int64_t)recs.size();
  for (int64_t i = 0; i < n; i++) {
    RecTmp& cr = recs[i];
    if (cr.mate_line >= 0) {
      if (cr.mate_line >= n) return false;
      if (cr.tlen == kI64Min) {
        int64_t id1 = i, id2 = i;
        int64_t aleft = cr.apos, aright = cr.aend;
        int32_t ref = cr.ref_id;
        int left_cnt = 0, right_cnt = 0;
        for (;;) {
          if (aleft > recs[id2].apos) { aleft = recs[id2].apos; left_cnt = 1; }
          else if (aleft == recs[id2].apos) left_cnt++;
          if (aright < recs[id2].aend) { aright = recs[id2].aend; right_cnt = 1; }
          else if (aright == recs[id2].aend) right_cnt++;
          if (recs[id2].mate_line == -1) {
            recs[id2].mate_line = i;
            break;
          }
          if (recs[id2].mate_line <= id2 || recs[id2].mate_line >= n)
            return false;
          id2 = recs[id2].mate_line;
          if (recs[id2].ref_id != ref) ref = -1;
          if (id2 == id1) break;
        }
        if (ref != -1) {
          int64_t tlen = aright - aleft + 1;
          id2 = i;
          RecTmp& r0 = recs[id2];
          if (r0.apos == aleft && (r0.aend < aright || left_cnt <= 1)) {
            r0.tlen = tlen;
            tlen = -tlen;
          } else if (r0.apos == aleft && r0.aend == aright && left_cnt > 1 &&
                     right_cnt > 1) {
            if (r0.flags & FREAD1) {
              r0.tlen = tlen;
              tlen = -tlen;
            } else {
              r0.tlen = -tlen;
            }
          } else {
            r0.tlen = -tlen;
          }
          id2 = r0.mate_line;
          while (id2 != i) {
            recs[id2].tlen = tlen;
            id2 = recs[id2].mate_line;
          }
        } else {
          id2 = i;
          recs[id2].tlen = 0;
          id2 = recs[id2].mate_line;
          while (id2 != i) {
            recs[id2].tlen = 0;
            id2 = recs[id2].mate_line;
          }
        }
      }
      RecTmp& mate = recs[cr.mate_line];
      cr.mate_pos = mate.apos;
      cr.mate_ref_id = mate.ref_id;
      cr.flags |= FPAIRED;
      if (mate.flags & FUNMAP) {
        cr.flags |= FMUNMAP;
        cr.tlen = 0;
      }
      if (cr.flags & FUNMAP) cr.tlen = 0;
      if (mate.flags & FREVERSE) cr.flags |= FMREVERSE;
    } else {
      if (cr.mate_flags & M_REVERSE) cr.flags |= FPAIRED | FMREVERSE;
      if (cr.mate_flags & M_UNMAP) cr.flags |= FMUNMAP;
      if (!(cr.flags & FPAIRED)) cr.mate_ref_id = -1;
    }
    if (cr.tlen == kI64Min) cr.tlen = 0;
  }
  for (auto& cr : recs) {
    if (cr.explicit_tlen != kI64Min) cr.tlen = cr.explicit_tlen;
  }
  return true;
}

// Everything one decoded slice owns: header, codec streams, records and
// the arenas their variable-length fields point into.
struct SliceDec {
  CompHdr h;
  Ctx x;
  SliceArgs a;
  DecState st;
  std::vector<RecTmp> recs;
};

// Decode a slice's records into sd (no output formatting).  Returns 0,
// kBail, or a negative error.
int64_t decode_slice_core(
    const uint8_t* comp_hdr, uint64_t comp_hdr_len,
    int32_t ref_seq_id, int64_t ref_seq_start, int64_t ref_seq_span,
    int32_t num_records, int64_t record_counter,
    int32_t n_blocks, const int32_t* content_types, const int32_t* content_ids,
    const uint64_t* blk_offs, const uint64_t* blk_lens, const uint8_t* blk_buf,
    const uint8_t* ref, uint64_t ref_window_len, int64_t ref_start,
    int64_t ref_chrom_len, int32_t n_rg, int32_t decode_md, SliceDec* sd) {
  if (ref_seq_id == -2) return kBail;  // multi-ref slices: python path
  CompHdr& h = sd->h;
  if (!parse_comp_hdr(&h, comp_hdr, comp_hdr_len)) return kBail;

  Ctx& x = sd->x;
  for (int32_t i = 0; i < n_blocks; i++) {
    if (content_types[i] == 5) {  // CT_CORE
      x.core.d = blk_buf + blk_offs[i];
      x.core.len = blk_lens[i];
    } else if (content_types[i] == 4) {  // CT_EXTERNAL
      x.ext[content_ids[i]] = Ext{blk_buf + blk_offs[i], blk_lens[i], 0};
    }
  }

  sd->a = SliceArgs{ref_seq_id, ref_seq_start, ref_seq_span, num_records,
                    record_counter, (h.no_ref ? nullptr : ref),
                    ref_window_len, ref_start, ref_chrom_len, n_rg,
                    decode_md};
  SliceArgs& a = sd->a;
  DecState& st = sd->st;
  st.h = &h;
  st.x = &x;
  st.a = &a;

  sd->recs.resize(num_records);
  std::vector<RecTmp>& recs = sd->recs;
  int64_t last_apos = ref_seq_start;
  Codec* BF = st.need(K('B', 'F'));
  if (st.bail) return kBail;
  Codec* CF = st.get(K('C', 'F'));
  Codec* RL = st.get(K('R', 'L'));
  Codec* AP = st.get(K('A', 'P'));
  Codec* RG = st.get(K('R', 'G'));
  Codec* RN = st.get(K('R', 'N'));
  Codec* MF = st.get(K('M', 'F'));
  Codec* NS = st.get(K('N', 'S'));
  Codec* NP = st.get(K('N', 'P'));
  Codec* TS = st.get(K('T', 'S'));
  Codec* NF = st.get(K('N', 'F'));
  Codec* BA = st.get(K('B', 'A'));
  Codec* QS = st.get(K('Q', 'S'));

  for (int32_t rec_i = 0; rec_i < num_records; rec_i++) {
    RecTmp& cr = recs[rec_i];
    cr.flags = codec_read_int(BF, &x);
    cr.cram_flags = CF ? codec_read_int(CF, &x) : 0;
    if (x.fail) return kBail;
    int64_t cf = cr.cram_flags;
    cr.ref_id = ref_seq_id;
    cr.len = RL ? codec_read_int(RL, &x) : 0;
    int64_t apos = AP ? codec_read_int(AP, &x) : ref_seq_start;
    if (h.AP_delta) apos += last_apos;
    last_apos = apos;
    cr.apos = apos;
    if (RG) {
      cr.rg = codec_read_int(RG, &x);
      if (cr.rg == -1 || cr.rg >= n_rg) cr.rg = -1;
    }
    if (x.fail) return kBail;
    if (h.read_names_included && RN) {
      cr.name_off = (uint32_t)st.names.len();
      if (!codec_read_array(RN, &x, &st.names)) return kBail;
      cr.name_len = (uint32_t)(st.names.len() - cr.name_off);
    }
    if (cf & CF_DETACHED) {
      cr.mate_flags = MF ? codec_read_int(MF, &x) : 0;
      if (!h.read_names_included && RN) {
        cr.name_off = (uint32_t)st.names.len();
        if (!codec_read_array(RN, &x, &st.names)) return kBail;
        cr.name_len = (uint32_t)(st.names.len() - cr.name_off);
      }
      if (NS) cr.mate_ref_id = (int32_t)codec_read_int(NS, &x);
      if (NP) cr.mate_pos = codec_read_int(NP, &x);
      cr.tlen = TS ? codec_read_int(TS, &x) : kI64Min;
    } else if (cf & CF_MATE_DOWNSTREAM) {
      if (NF) cr.mate_line = codec_read_int(NF, &x) + rec_i + 1;
      cr.tlen = kI64Min;
      if ((cf & CF_EXPLICIT_TLEN) && TS)
        cr.explicit_tlen = codec_read_int(TS, &x);
    } else if (cf & CF_EXPLICIT_TLEN) {
      if (TS) cr.explicit_tlen = codec_read_int(TS, &x);
    }
    if (x.fail) return kBail;
    int has_MD = 0, has_NM = 0;
    if (!decode_aux(&st, &cr, &has_MD, &has_NM)) return kBail;
    if (!(cr.flags & FUNMAP)) {
      if (!decode_seq(&st, &cr, (int)cf, has_MD, has_NM)) return kBail;
    } else {
      cr.aend = cr.apos;
      cr.mqual = 0;
      if (BA && cr.len) {
        if (cr.len < 0 || cr.len > (1 << 28)) return kBail;
        cr.seq_off = (uint32_t)st.seqs.len();
        codec_read_bytes(BA, &x, (uint64_t)cr.len, &st.seqs);
        if (x.fail) return kBail;
        cr.seq_len = (uint32_t)(st.seqs.len() - cr.seq_off);
      }
      if (cf & CF_PRESERVE_QUAL) {
        if (QS && cr.len >= 0) {
          cr.qual_off = (uint32_t)st.quals.len();
          codec_read_bytes(QS, &x, (uint64_t)cr.len, &st.quals);
          if (x.fail) return kBail;
          cr.qual_len = (uint32_t)(st.quals.len() - cr.qual_off);
        }
      } else {
        cr.qual_off = (uint32_t)st.quals.len();
        cr.qual_len = (uint32_t)std::max<int64_t>(cr.len, 0);
        st.quals.put_fill((char)0xFF, cr.qual_len);
      }
      if (cr.seq_len == 0) {
        cr.qual_len = 0;
        cr.len = 0;
      }
    }
    if (!h.qs_seq_orient && (cr.flags & FREVERSE) && cr.qual_len)
      std::reverse(st.quals.data() + cr.qual_off,
                   st.quals.data() + cr.qual_off + cr.qual_len);
    // the RecTmp views are uint32 (offset,len) pairs into the arenas: a
    // hostile slice (2^31 records x 2^28-byte seqs) could push an arena
    // past 4 GiB and wrap the offsets into silent corruption — bail first
    if (st.names.len() > UINT32_MAX || st.auxs.len() > UINT32_MAX ||
        st.seqs.len() > UINT32_MAX || st.quals.len() > UINT32_MAX ||
        st.cigs.size() > UINT32_MAX)
      return kBail;
  }

  if (!slice_xref(recs)) return kBail;
  return 0;
}

// Resolve record i's qname (own name, mate's, or generated into gen[]).
inline bool qname_of(SliceDec& sd, int32_t i, char gen[40],
                     const char** qname, uint32_t* qlen) {
  RecTmp& cr = sd.recs[i];
  int32_t num_records = (int32_t)sd.recs.size();
  if (cr.name_len) {
    *qname = (const char*)sd.st.names.data() + cr.name_off;
    *qlen = cr.name_len;
  } else if (cr.mate_line >= 0 && cr.mate_line < num_records &&
             sd.recs[cr.mate_line].name_len) {
    *qname = (const char*)sd.st.names.data() + sd.recs[cr.mate_line].name_off;
    *qlen = sd.recs[cr.mate_line].name_len;
  } else {
    int64_t mate_i = (cr.mate_line >= 0 && cr.mate_line < i) ? cr.mate_line
                                                             : i;
    int gl = snprintf(gen, 40, "?:%lld",
                      (long long)(sd.a.record_counter + mate_i + 1));
    *qname = gen;
    *qlen = (uint32_t)gl;
  }
  return *qlen != 0 && *qlen <= 254;
}

// cram_to_bam (decode.py:858): pack record i as one u32-framed BAM record.
bool pack_one(SliceDec& sd, int32_t i, int32_t n_rg, const uint8_t* rg_buf,
              const uint64_t* rg_offs, const uint32_t* rg_lens,
              const uint8_t* rg_valid, Buf& out) {
  DecState& st = sd.st;
  RecTmp& cr = sd.recs[i];
  char gen[40];
  const char* qname;
  uint32_t qlen;
  if (!qname_of(sd, i, gen, &qname, &qlen)) return false;
  if (cr.flags < 0 || cr.flags > 0xFFFF) return false;
  if (cr.cig_cnt > 0xFFFF) return false;  // CG escape: python path
  const uint32_t* cig = st.cigs.data() + cr.cig_off;
  int64_t l_qseq = (int64_t)cr.seq_len;
  if (l_qseq > 0 && (int64_t)cr.qual_len != l_qseq) return false;
  if (cr.mqual < 0 || cr.mqual > 0xFF) return false;
  int64_t rlen = 0;
  if (!(cr.flags & FUNMAP)) {
    for (uint32_t k = 0; k < cr.cig_cnt; k++) {
      uint32_t c = cig[k];
      int op = (int)(c & 0xF);
      if (op == CMATCH || op == CDEL || op == CREF_SKIP || op == 7 ||
          op == 8)
        rlen += c >> 4;
    }
  }
  int64_t pos0 = cr.apos - 1;
  int32_t bin = reg2bin_c(pos0, pos0 + (rlen ? rlen : 1));
  uint32_t l_qname = qlen + 1;
  uint32_t rg_len = 0;
  const uint8_t* rg_at = nullptr;
  if (cr.rg >= 0 && cr.rg < n_rg && rg_valid[cr.rg]) {
    rg_at = rg_buf + rg_offs[cr.rg];
    rg_len = rg_lens[cr.rg];
  }
  uint64_t bsz = 32 + l_qname + 4ull * cr.cig_cnt +
                 (uint64_t)((l_qseq + 1) / 2) + (uint64_t)l_qseq +
                 cr.aux_len + (rg_at ? 4ull + rg_len : 0);
  if (bsz > 0x7FFFFFFF) return false;
  out.reserve(4 + bsz);
  uint32_t u32 = (uint32_t)bsz;
  out.put(&u32, 4);
  int32_t i32 = cr.ref_id;
  out.put(&i32, 4);
  i32 = (int32_t)pos0;
  out.put(&i32, 4);
  out.putc((char)(uint8_t)l_qname);
  out.putc((char)(uint8_t)cr.mqual);
  uint16_t u16 = (uint16_t)bin;
  out.put(&u16, 2);
  u16 = (uint16_t)cr.cig_cnt;
  out.put(&u16, 2);
  u16 = (uint16_t)cr.flags;
  out.put(&u16, 2);
  i32 = (int32_t)l_qseq;
  out.put(&i32, 4);
  i32 = cr.mate_ref_id;
  out.put(&i32, 4);
  i32 = (int32_t)(cr.mate_pos - 1);
  out.put(&i32, 4);
  if (cr.tlen < INT32_MIN || cr.tlen > INT32_MAX) return false;
  i32 = (int32_t)cr.tlen;
  out.put(&i32, 4);
  out.put(qname, qlen);
  out.putc('\0');
  if (cr.cig_cnt) out.put(cig, 4 * (size_t)cr.cig_cnt);
  if (l_qseq) {
    out.reserve((size_t)((l_qseq + 1) / 2));
    uint8_t* dst = out.data() + out.len();
    const uint8_t* s = st.seqs.data() + cr.seq_off;
    for (int64_t k = 0; k < l_qseq / 2; k++)
      dst[k] = (uint8_t)((kNt16Enc.t[s[2 * k]] << 4) |
                         kNt16Enc.t[s[2 * k + 1]]);
    if (l_qseq & 1)
      dst[l_qseq / 2] = (uint8_t)(kNt16Enc.t[s[l_qseq - 1]] << 4);
    out.bump((size_t)((l_qseq + 1) / 2));
    out.put(st.quals.data() + cr.qual_off, cr.qual_len);
  }
  out.put(st.auxs.data() + cr.aux_off, cr.aux_len);
  if (rg_at) {
    out.put("RGZ", 3);
    out.put(rg_at, rg_len);
    out.putc('\0');
  }
  return true;
}

}  // namespace cramdec

extern "C" {

// Decode one CRAM v3 slice to a u32-framed BAM record stream.
// Returns total bytes via *out_ptr (htstpu_buf_free to release),
// -100 = unsupported/bail (caller uses the Python decoder), -1 = OOM.
int64_t htstpu_cram_decode_slice(
    const uint8_t* comp_hdr, uint64_t comp_hdr_len,
    int32_t ref_seq_id, int64_t ref_seq_start, int64_t ref_seq_span,
    int32_t num_records, int64_t record_counter,
    int32_t n_blocks, const int32_t* content_types, const int32_t* content_ids,
    const uint64_t* blk_offs, const uint64_t* blk_lens, const uint8_t* blk_buf,
    const uint8_t* ref, uint64_t ref_window_len, int64_t ref_start,
    int64_t ref_chrom_len,
    int32_t n_rg, const uint8_t* rg_buf, const uint64_t* rg_offs,
    const uint32_t* rg_lens, const uint8_t* rg_valid,
    int32_t decode_md, uint8_t** out_ptr) {
  using namespace cramdec;
  SliceDec sd;
  int64_t rc = decode_slice_core(
      comp_hdr, comp_hdr_len, ref_seq_id, ref_seq_start, ref_seq_span,
      num_records, record_counter, n_blocks, content_types, content_ids,
      blk_offs, blk_lens, blk_buf, ref, ref_window_len, ref_start,
      ref_chrom_len, n_rg, decode_md, &sd);
  if (rc < 0) return rc;

  Buf out;
  for (int32_t i = 0; i < num_records; i++) {
    if (!pack_one(sd, i, n_rg, rg_buf, rg_offs, rg_lens, rg_valid, out))
      return kBail;
  }

  uint8_t* res = (uint8_t*)malloc(out.len() ? out.len() : 1);
  if (!res) return -1;
  memcpy(res, out.data(), out.len());
  *out_ptr = res;
  return (int64_t)out.len();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused CRAM slice -> SAM text: block decompression (all CRAM 3.x methods
// incl. the 3.1 codecs from htscodecs_shim), slice decode and SAM
// formatting in one native call — the per-slice unit the decode-ahead
// pipeline (cram_decode.c:3047 cram_decode_slice_mt) dispatches to
// workers.  GIL-free end to end; Python only frames containers.
// ---------------------------------------------------------------------------

extern "C" {
#include "../htscodecs_shim/rANS_static4x16.h"
#include "../htscodecs_shim/arith_dynamic.h"
#include "../htscodecs_shim/fqzcomp_qual.h"
#include "../htscodecs_shim/tokenise_name3.h"
}

namespace {

// returns 0 ok, -1 corrupt, -2 unsupported-method (caller bails to python)
// BZ2_bzBuffToBuffDecompress via dlopen: the image ships libbz2.so.1
// without dev headers or a .so symlink; the ABI is stable so the
// prototype is declared locally (bzlib.h signature).
typedef int (*bz2_d_fn)(char*, unsigned*, char*, unsigned, int, int);
static int bz2_buff_decompress(const uint8_t* in, uint64_t in_len,
                               uint8_t* out, uint64_t raw_size) {
  static bz2_d_fn fn = [] {
    void* h = dlopen("libbz2.so.1", RTLD_NOW);
    return h ? (bz2_d_fn)dlsym(h, "BZ2_bzBuffToBuffDecompress") : nullptr;
  }();
  if (!fn || raw_size > 0xFFFFFFFFull || in_len > 0xFFFFFFFFull)
    return -2;                       // python path decodes instead
  unsigned dl = (unsigned)raw_size;
  int r = fn((char*)out, &dl, (char*)in, (unsigned)in_len, 0, 0);
  return (r == 0 && dl == raw_size) ? 0 : -1;
}

int cram_block_uncompress(int method, const uint8_t* in, uint64_t in_len,
                          uint8_t* out, uint64_t raw_size) {
  if (raw_size == 0 && in_len == 0) return 0;
  switch (method) {
    case 0:  // RAW
      if (in_len != raw_size) return -1;
      memcpy(out, in, raw_size);
      return 0;
    case 1: {  // GZIP
      size_t actual = 0;
      libdeflate_decompressor* d = t_decomp.get();
      if (libdeflate_gzip_decompress(d, in, in_len, out, raw_size,
                                     &actual) == LIBDEFLATE_SUCCESS
          && actual == raw_size)
        return 0;
      if (libdeflate_zlib_decompress(d, in, in_len, out, raw_size,
                                     &actual) == LIBDEFLATE_SUCCESS
          && actual == raw_size)
        return 0;
      return -1;
    }
    case 4:  // RANS (4x8)
      return htstpu_rans4x8_uncompress(in, in_len, out, raw_size)
                 == (int64_t)raw_size ? 0 : -1;
    case 5: {  // RANSPR (Nx16)
      unsigned int osz = (unsigned int)raw_size;
      return rans_uncompress_to_4x16((unsigned char*)in,
                                     (unsigned int)in_len, out, &osz)
                 && osz == raw_size ? 0 : -1;
    }
    case 6: {  // ARITH
      unsigned int osz = (unsigned int)raw_size;
      return arith_uncompress_to((unsigned char*)in, (unsigned int)in_len,
                                 out, &osz)
                 && osz == raw_size ? 0 : -1;
    }
    case 7: {  // FQZ
      size_t osz = 0;
      char* r = fqz_decompress((char*)in, in_len, &osz, nullptr, 0);
      if (!r || osz != raw_size) { free(r); return -1; }
      memcpy(out, r, osz);
      free(r);
      return 0;
    }
    case 8: {  // TOK3
      uint32_t osz = 0;
      uint8_t* r = tok3_decode_names((uint8_t*)in, (uint32_t)in_len, &osz);
      if (!r) return -1;
      if (osz != raw_size) { free(r); return -2; }
      memcpy(out, r, osz);
      free(r);
      return 0;
    }
    case 2:    // BZIP2 (cram/cram_io.c:1593): runtime-loaded libbz2.so.1
      return bz2_buff_decompress(in, in_len, out, raw_size);
    case 3: {  // LZMA (cram/cram_io.c:1633): xz stream container
      uint64_t memlimit = UINT64_MAX;
      size_t in_pos = 0, out_pos = 0;
      lzma_ret r = lzma_stream_buffer_decode(
          &memlimit, 0, nullptr, in, &in_pos, in_len, out, &out_pos,
          raw_size);
      return (r == LZMA_OK && out_pos == raw_size) ? 0 : -1;
    }
    default:   // unknown: python path handles these
      return -2;
  }
}

}  // namespace

extern "C" {

// Returns SAM text length via *out_ptr, kBail (-100) for configurations
// the native path does not cover, -1 on malloc failure, -2 on corrupt
// input.
int64_t htstpu_cram_slice_to_sam(
    const uint8_t* comp_hdr, uint64_t comp_hdr_len,
    int32_t ref_seq_id, int64_t ref_seq_start, int64_t ref_seq_span,
    int32_t num_records, int64_t record_counter,
    int32_t n_blocks, const int32_t* content_types,
    const int32_t* content_ids, const int32_t* methods,
    const uint64_t* raw_sizes, const uint64_t* blk_offs,
    const uint64_t* blk_lens, const uint8_t* blk_buf,
    const uint8_t* ref, uint64_t ref_window_len, int64_t ref_start,
    int64_t ref_chrom_len,
    int32_t n_rg, const uint8_t* rg_buf, const uint64_t* rg_offs,
    const uint32_t* rg_lens, const uint8_t* rg_valid,
    int32_t decode_md,
    const uint8_t* name_buf, const uint64_t* name_offs,
    const uint32_t* name_lens, int32_t n_ref,
    uint8_t** out_ptr) {
  // 1. decompress every block into one arena
  uint64_t t0 = prof_now();
  uint64_t total_raw = 0;
  for (int32_t i = 0; i < n_blocks; i++) total_raw += raw_sizes[i];
  std::vector<uint8_t> arena(total_raw ? total_raw : 1);
  std::vector<uint64_t> uoffs(n_blocks ? n_blocks : 1);
  uint64_t uo = 0;
  for (int32_t i = 0; i < n_blocks; i++) {
    uoffs[i] = uo;
    int rc = cram_block_uncompress(methods[i], blk_buf + blk_offs[i],
                                   blk_lens[i], arena.data() + uo,
                                   raw_sizes[i]);
    if (rc == -2) return -100;
    if (rc != 0) return -2;
    uo += raw_sizes[i];
  }
  uint64_t t1 = prof_now();
  g_prof[0] += t1 - t0;

  // 2. slice decode into record views over slice arenas
  using namespace cramdec;
  SliceDec sd;
  int64_t drc = decode_slice_core(
      comp_hdr, comp_hdr_len, ref_seq_id, ref_seq_start, ref_seq_span,
      num_records, record_counter, n_blocks, content_types, content_ids,
      uoffs.data(), raw_sizes, arena.data(), ref, ref_window_len,
      ref_start, ref_chrom_len, n_rg, decode_md, &sd);
  if (drc < 0) return drc;
  uint64_t t2 = prof_now();
  g_prof[1] += t2 - t1;

  // 3. format records as SAM text straight from the arenas — no
  // intermediate BAM blob (no nibble pack/unpack round-trip).  Rare
  // records that may need the CG long-cigar escape detour through
  // pack_one + format_record, which owns that logic (sam.c:680).
  NameTable nt{name_buf, name_offs, name_lens, n_ref};
  nt.max_name = nt.max_len();
  DecState& st = sd.st;
  Buf out;
  out.reserve(st.seqs.len() * 5 / 2 + (size_t)num_records * 64 + 4096);
  Buf scratch;
  char gen[40];
  // canonical base mapping: what a BAM nibble round-trip would emit
  static const struct Canon {
    uint8_t t[256];
    Canon() {
      for (int i = 0; i < 256; i++) t[i] = kNt16[kNt16Enc.t[i] & 0xF];
    }
  } kCanon;
  for (int32_t i = 0; i < num_records; i++) {
    RecTmp& cr = sd.recs[i];
    const uint32_t* cig = st.cigs.data() + cr.cig_off;
    if (cr.cig_cnt > 0 && cr.ref_id >= 0 && cr.apos - 1 >= 0 &&
        cig[0] == (((uint32_t)cr.seq_len << 4) | 4)) {
      // possible CG-escape shape: let the BAM formatter decide
      scratch.clear();
      if (!pack_one(sd, i, n_rg, rg_buf, rg_offs, rg_lens, rg_valid,
                    scratch))
        return kBail;
      if (format_record(scratch.data() + 4, (uint32_t)(scratch.len() - 4),
                        nt, &out) < 0)
        return -2;
      continue;
    }
    const char* qname;
    uint32_t qlen;
    if (!qname_of(sd, i, gen, &qname, &qlen)) return kBail;
    if (cr.flags < 0 || cr.flags > 0xFFFF) return kBail;
    if (cr.cig_cnt > 0xFFFF) return kBail;  // CG escape: python path
    int64_t l_qseq = (int64_t)cr.seq_len;
    if (l_qseq > 0 && (int64_t)cr.qual_len != l_qseq) return kBail;
    if (cr.mqual < 0 || cr.mqual > 0xFF) return kBail;
    if (cr.tlen < INT32_MIN || cr.tlen > INT32_MAX) return kBail;
    out.put(qname, qlen);
    out.putc('\t');
    out.put_i64(cr.flags);
    out.putc('\t');
    int32_t tid = cr.ref_id;
    if (tid >= 0 && tid < nt.n_ref)
      out.put(nt.buf + nt.offs[tid], nt.lens[tid]);
    else
      out.putc('*');
    out.putc('\t');
    out.put_i64(cr.apos);
    out.putc('\t');
    out.put_i64(cr.mqual);
    out.putc('\t');
    if (cr.cig_cnt == 0) {
      out.putc('*');
    } else {
      for (uint32_t k = 0; k < cr.cig_cnt; k++) {
        uint32_t c = cig[k];
        out.put_i64(c >> 4);
        out.putc(kCigChar[c & 0xF]);
      }
    }
    out.putc('\t');
    int32_t mtid = cr.mate_ref_id;
    if (mtid < 0) out.putc('*');
    else if (mtid == tid) out.putc('=');
    else if (mtid < nt.n_ref) out.put(nt.buf + nt.offs[mtid], nt.lens[mtid]);
    else out.putc('*');
    out.putc('\t');
    out.put_i64(cr.mate_pos);
    out.putc('\t');
    out.put_i64(cr.tlen);
    out.putc('\t');
    if (l_qseq == 0) {
      out.putc('*');
    } else {
      out.reserve((size_t)l_qseq);
      uint8_t* dst = out.data() + out.len();
      const uint8_t* s = st.seqs.data() + cr.seq_off;
      for (int64_t k = 0; k < l_qseq; k++) dst[k] = kCanon.t[s[k]];
      out.bump((size_t)l_qseq);
    }
    out.putc('\t');
    const uint8_t* q = st.quals.data() + cr.qual_off;
    if (l_qseq == 0 || q[0] == 0xFF) {
      out.putc('*');
    } else {
      out.reserve((size_t)l_qseq);
      uint8_t* dst = out.data() + out.len();
      for (int64_t k = 0; k < l_qseq; k++) dst[k] = q[k] + 33;
      out.bump((size_t)l_qseq);
    }
    if (format_aux(st.auxs.data() + cr.aux_off, cr.aux_len, -1, 0,
                   &out) < 0)
      return -2;
    if (cr.rg >= 0 && cr.rg < n_rg && rg_valid[cr.rg]) {
      out.put("\tRG:Z:", 6);
      out.put(rg_buf + rg_offs[cr.rg], rg_lens[cr.rg]);
    }
    out.putc('\n');
  }
  g_prof[2] += prof_now() - t2;

  uint8_t* res = (uint8_t*)malloc(out.len() ? out.len() : 1);
  if (!res) return -1;
  memcpy(res, out.data(), out.len());
  *out_ptr = res;
  return (int64_t)out.len();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native CRAM slice encoder: the process_one_read hot loop
// (cram_encode.c:3382) over a u32-framed BAM record blob.  Produces the
// per-data-series streams + tag dictionary + slice stats in one packed
// buffer; Python builds the compression header and container framing
// (cold path) and runs the codec metrics over the returned streams.
// Fast path covers CRAM v3, non-multiref slices, full names, no
// embedded ref; anything else returns kBail for the Python encoder.
// ---------------------------------------------------------------------------

namespace cramenc {

constexpr int64_t kBail = -100;

// ITF8 writer (cram/cram_io.c:138 semantics; itf8.py mirror)
inline void put_itf8(Buf* b, int64_t val) {
  uint32_t v = (uint32_t)val;
  b->reserve(5);
  uint8_t* d = b->data() + b->len();
  if (v < 0x80) {
    d[0] = (uint8_t)v;
    b->bump(1);
  } else if (v < 0x4000) {
    d[0] = (uint8_t)(0x80 | (v >> 8));
    d[1] = (uint8_t)v;
    b->bump(2);
  } else if (v < 0x200000) {
    d[0] = (uint8_t)(0xC0 | (v >> 16));
    d[1] = (uint8_t)(v >> 8);
    d[2] = (uint8_t)v;
    b->bump(3);
  } else if (v < 0x10000000) {
    d[0] = (uint8_t)(0xE0 | (v >> 24));
    d[1] = (uint8_t)(v >> 16);
    d[2] = (uint8_t)(v >> 8);
    d[3] = (uint8_t)v;
    b->bump(4);
  } else {
    d[0] = (uint8_t)(0xF0 | (v >> 28));
    d[1] = (uint8_t)(v >> 20);
    d[2] = (uint8_t)(v >> 12);
    d[3] = (uint8_t)(v >> 4);
    d[4] = (uint8_t)(v & 0x0F);
    b->bump(5);
  }
}

// series content ids (encode.py SERIES)
enum {
  S_BF = 1, S_CF = 2, S_RI = 3, S_RL = 4, S_AP = 5, S_RG = 6, S_MF = 7,
  S_NS = 8, S_NP = 9, S_TS = 10, S_TL = 11, S_FN = 12, S_FC = 13,
  S_FP = 14, S_DL = 15, S_BA = 16, S_BS = 17, S_MQ = 18, S_QS = 19,
  S_IN = 20, S_RN = 21, S_SC = 22, S_HC = 23, S_PD = 24, S_RS = 25,
  S_BB = 26, S_BB_LEN = 27, S_NF = 28, S_MAX = 29
};

constexpr uint32_t kTagIdBase = 0x100000;

constexpr uint16_t FPAIRED = 1, FUNMAP = 4, FMUNMAP = 8, FREVERSE = 16,
                   FMREVERSE = 32, FREAD1 = 64, FSECONDARY = 256,
                   FSUPP = 2048;
constexpr int64_t CF_PRESERVE_QUAL = 1, CF_DETACHED = 2,
                  CF_MATE_DOWNSTREAM = 4, CF_NO_SEQ = 8;
constexpr int64_t M_REVERSE = 1, M_UNMAP = 2;

struct RecView {
  const uint8_t* rec;
  uint32_t size;
  int32_t tid, pos, mtid, mpos, tlen;
  uint16_t flag, n_cigar;
  uint8_t l_qname, mapq;
  int32_t l_qseq;
  const uint8_t* qname;   // incl. trailing NUL
  const uint8_t* cig;
  const uint8_t* seq;     // packed nibbles
  const uint8_t* qual;
  const uint8_t* aux;
  const uint8_t* end;
};

inline bool parse_rec(const uint8_t* rec, uint32_t size, RecView* v) {
  if (size < 32) return false;
  v->rec = rec;
  v->size = size;
  v->tid = (int32_t)rd_u32(rec + 0);
  v->pos = (int32_t)rd_u32(rec + 4);
  v->l_qname = rec[8];
  v->mapq = rec[9];
  v->n_cigar = rd_u16(rec + 12);
  v->flag = rd_u16(rec + 14);
  v->l_qseq = (int32_t)rd_u32(rec + 16);
  v->mtid = (int32_t)rd_u32(rec + 20);
  v->mpos = (int32_t)rd_u32(rec + 24);
  v->tlen = (int32_t)rd_u32(rec + 28);
  v->qname = rec + 32;
  v->cig = v->qname + v->l_qname;
  v->seq = v->cig + 4ull * v->n_cigar;
  v->qual = v->seq + (v->l_qseq + 1) / 2;
  v->aux = v->qual + v->l_qseq;
  v->end = rec + size;
  return v->l_qseq >= 0 && v->aux <= v->end && v->l_qname > 0;
}

inline int64_t cigar2qlen(const RecView& v) {
  int64_t n = 0;
  static const uint16_t qmask = (1 << 0) | (1 << 1) | (1 << 4) | (1 << 7)
                                | (1 << 8);  // M I S = X
  for (uint32_t k = 0; k < v.n_cigar; k++) {
    uint32_t c = rd_u32(v.cig + 4ull * k);
    if (qmask & (1u << (c & 0xF))) n += c >> 4;
  }
  return n;
}

inline int64_t cigar2rlen(const RecView& v) {
  int64_t n = 0;
  static const uint16_t rmask = (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7)
                                | (1 << 8);  // M D N = X
  for (uint32_t k = 0; k < v.n_cigar; k++) {
    uint32_t c = rd_u32(v.cig + 4ull * k);
    if (rmask & (1u << (c & 0xF))) n += c >> 4;
  }
  return n;
}

inline int64_t aend(const RecView& v) {
  int64_t ap = v.pos + 1;
  if (v.flag & FUNMAP) return ap;
  int64_t rl = cigar2rlen(v);
  return rl > 0 ? ap + rl - 1 : ap;
}

// _mate_link_ok port (encode.py): link only when the decoder's xref
// reproduces both records' mate fields, flags and tlen exactly
inline bool mate_link_ok(const RecView& a, const RecView& b) {
  int64_t apos_a = a.pos + 1, apos_b = b.pos + 1;
  int64_t aend_a = aend(a), aend_b = aend(b);
  int64_t aleft = apos_a < apos_b ? apos_a : apos_b;
  int64_t aright = aend_a > aend_b ? aend_a : aend_b;
  int left_cnt = (apos_a == aleft) + (apos_b == aleft);
  int right_cnt = (aend_a == aright) + (aend_b == aright);
  int64_t tlen_a, tlen_b;
  if (a.tid != b.tid) {
    tlen_a = tlen_b = 0;
  } else {
    int64_t tlen = aright - aleft + 1;
    if (apos_a == aleft && (aend_a < aright || left_cnt <= 1)) {
      tlen_a = tlen;
      tlen_b = -tlen;
    } else if (apos_a == aleft && aend_a == aright && left_cnt > 1
               && right_cnt > 1) {
      if (a.flag & FREAD1) { tlen_a = tlen; tlen_b = -tlen; }
      else { tlen_a = -tlen; tlen_b = tlen; }
    } else {
      tlen_a = -tlen;
      tlen_b = tlen;
    }
  }
  const RecView* xs[2] = {&a, &b};
  const RecView* ys[2] = {&b, &a};
  int64_t tls[2] = {tlen_a, tlen_b};
  for (int k = 0; k < 2; k++) {
    const RecView& x = *xs[k];
    const RecView& y = *ys[k];
    int64_t tl = tls[k];
    uint32_t fl = x.flag | FPAIRED;
    if (y.flag & FUNMAP) {
      fl |= FMUNMAP;
      tl = 0;
    }
    if (x.flag & FUNMAP) tl = 0;
    if (y.flag & FREVERSE) fl |= FMREVERSE;
    if (fl != x.flag || y.tid != x.mtid || y.pos != x.mpos
        || tl != x.tlen)
      return false;
  }
  return true;
}

static const char kSubRow0[] = "CGTN";
static const char kSubRow1[] = "AGTN";
static const char kSubRow2[] = "ACTN";
static const char kSubRow3[] = "ACGN";
static const char kSubRow4[] = "ACGT";
static const char* kSubRows[5] = {kSubRow0, kSubRow1, kSubRow2, kSubRow3,
                                  kSubRow4};

inline int l1_of(uint8_t b) {
  switch (b) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return 4;
  }
}

inline int sub_code(uint8_t refb, uint8_t b) {
  const char* row = kSubRows[l1_of(refb)];
  for (int i = 0; i < 4; i++)
    if ((uint8_t)row[i] == b) return i;
  return -1;
}

struct StrKey {
  const uint8_t* s;
  uint32_t len;
  bool operator==(const StrKey& o) const {
    return len == o.len && memcmp(s, o.s, len) == 0;
  }
};
struct StrKeyHash {
  size_t operator()(const StrKey& k) const {
    size_t h = 1469598103934665603ull;
    for (uint32_t i = 0; i < k.len; i++)
      h = (h ^ k.s[i]) * 1099511628211ull;
    return h;
  }
};

}  // namespace cramenc

extern "C" {

// Returns the packed result length via *out_ptr (htstpu_buf_free to
// release), kBail (-100) for configurations left to Python, -2 on
// malformed records.  Packed layout (all LE):
//   u32 n_records; u64 nbases; u64 end_pos(1-based incl, 0 if none);
//   u32 n_streams; n_streams x { i32 cid; u64 len };
//   u32 n_td; u64 td_len; td bytes (nul-separated lines);
//   n_records x u32 rec_tl; n_records x u32 qs_len;
//   stream bytes in table order.
int64_t htstpu_cram_encode_slice(
    const uint8_t* blob, uint64_t blob_len,
    int32_t slice_ref, int64_t slice_start,
    const uint8_t* ref, uint64_t ref_len, int64_t ref_start,
    int32_t use_ref, uint8_t** out_ptr) {
  using namespace cramenc;

  // parse records
  std::vector<RecView> recs;
  {
    uint64_t p = 0;
    while (p + 4 <= blob_len) {
      uint32_t bsz;
      memcpy(&bsz, blob + p, 4);
      if (p + 4 + bsz > blob_len) return -2;
      RecView v;
      if (!parse_rec(blob + p + 4, bsz, &v)) return -2;
      recs.push_back(v);
      p += 4 + bsz;
    }
    if (p != blob_len) return -2;
  }
  int64_t n = (int64_t)recs.size();

  // multiref slices are the python path's job
  for (auto& r : recs)
    if (r.tid != slice_ref) return kBail;

  // mate linkage pre-pass
  std::vector<int32_t> link(n, -1);
  std::vector<uint8_t> linked_down(n, 0);
  {
    std::unordered_map<StrKey, int64_t, StrKeyHash> pending;
    for (int64_t i = 0; i < n; i++) {
      const RecView& r = recs[i];
      if (!(r.flag & FPAIRED) || (r.flag & (FSECONDARY | FSUPP)))
        continue;
      StrKey k{r.qname, (uint32_t)(r.l_qname - 1)};
      auto it = pending.find(k);
      if (it == pending.end()) {
        pending.emplace(k, i);
      } else {
        int64_t j = it->second;
        pending.erase(it);
        if (mate_link_ok(recs[j], recs[i])) {
          link[j] = (int32_t)i;
          linked_down[i] = 1;
        }
      }
    }
  }

  // streams
  std::vector<Buf> series(S_MAX);
  std::unordered_map<uint32_t, Buf> tag_streams;
  std::unordered_map<StrKey, uint32_t, StrKeyHash> td_map;
  std::vector<std::vector<uint8_t>> td_lines;
  std::vector<uint32_t> rec_tl((size_t)n);
  std::vector<uint32_t> qs_lens;
  qs_lens.reserve((size_t)n);
  std::vector<uint8_t> seq_buf;   // current record's unpacked bases
  std::vector<uint8_t> line_buf;

  int64_t nbases = 0, end_pos = 0;

  for (int64_t i = 0; i < n; i++) {
    const RecView& r = recs[i];
    nbases += r.l_qseq;
    int64_t cf = CF_PRESERVE_QUAL;
    if (link[i] >= 0)
      cf |= CF_MATE_DOWNSTREAM;
    else if (!linked_down[i])
      cf |= CF_DETACHED;
    int64_t qlen = r.l_qseq;
    if (qlen == 0) {
      cf |= CF_NO_SEQ;
      if (!(r.flag & FUNMAP) && r.n_cigar) qlen = cigar2qlen(r);
    }
    put_itf8(&series[S_BF], r.flag);
    put_itf8(&series[S_CF], cf);
    put_itf8(&series[S_RL], qlen);
    put_itf8(&series[S_AP], (int64_t)r.pos + 1);
    put_itf8(&series[S_RG], -1);
    series[S_RN].put(r.qname, r.l_qname - 1);
    series[S_RN].putc('\0');
    if (cf & CF_DETACHED) {
      int64_t mf = 0;
      if (r.flag & FMREVERSE) mf |= M_REVERSE;
      if (r.flag & FMUNMAP) mf |= M_UNMAP;
      put_itf8(&series[S_MF], mf);
      put_itf8(&series[S_NS], r.mtid);
      put_itf8(&series[S_NP], (int64_t)r.mpos + 1);
      put_itf8(&series[S_TS], r.tlen);
    } else if (cf & CF_MATE_DOWNSTREAM) {
      put_itf8(&series[S_NF], link[i] - i - 1);
    }

    // aux tags -> TD line + per-tag streams
    line_buf.clear();
    {
      const uint8_t* a = r.aux;
      const uint8_t* e = r.end;
      while (a + 3 <= e) {
        uint8_t t = a[2];
        const uint8_t* vstart = a + 3;
        const uint8_t* vend = vstart;
        switch (t) {
          case 'A': case 'c': case 'C': vend = vstart + 1; break;
          case 's': case 'S': vend = vstart + 2; break;
          case 'i': case 'I': case 'f': vend = vstart + 4; break;
          case 'd': vend = vstart + 8; break;
          case 'Z': case 'H': {
            const uint8_t* z = vstart;
            while (z < e && *z) z++;
            if (z >= e) return -2;
            vend = z + 1;
            break;
          }
          case 'B': {
            if (vstart + 5 > e) return -2;
            uint8_t sub = vstart[0];
            uint32_t cnt = rd_u32(vstart + 1);
            uint32_t es = (sub == 'c' || sub == 'C' || sub == 'A') ? 1
                        : (sub == 's' || sub == 'S') ? 2
                        : (sub == 'i' || sub == 'I' || sub == 'f') ? 4 : 0;
            if (!es) return -2;
            vend = vstart + 5 + (uint64_t)es * cnt;
            break;
          }
          default: return -2;
        }
        if (vend > e) return -2;
        line_buf.push_back(a[0]);
        line_buf.push_back(a[1]);
        line_buf.push_back(t);
        uint32_t kid = ((uint32_t)a[0] << 16) | ((uint32_t)a[1] << 8) | t;
        Buf& ts = tag_streams[kid];
        put_itf8(&ts, (int64_t)(vend - vstart));
        ts.put(vstart, (size_t)(vend - vstart));
        a = vend;
      }
      if (a != e) return -2;
    }
    {
      StrKey k{line_buf.data(), (uint32_t)line_buf.size()};
      auto it = td_map.find(k);
      uint32_t tl;
      if (it == td_map.end()) {
        td_lines.emplace_back(line_buf.begin(), line_buf.end());
        tl = (uint32_t)(td_lines.size() - 1);
        StrKey owned{td_lines.back().data(), (uint32_t)line_buf.size()};
        td_map.emplace(owned, tl);
      } else {
        tl = it->second;
      }
      rec_tl[(size_t)i] = tl;
    }

    // features
    if (!(r.flag & FUNMAP)) {
      // unpack bases once
      const char* kNt = "=ACMGRSVTWYHKDBN";
      seq_buf.resize((size_t)r.l_qseq);
      for (int64_t k = 0; k < r.l_qseq; k++) {
        uint8_t pk = r.seq[k >> 1];
        seq_buf[(size_t)k] =
            (uint8_t)kNt[(k & 1) ? (pk & 0xF) : (pk >> 4)];
      }
      bool have_seq = r.l_qseq > 0;
      struct Feat { int64_t fpos; uint8_t code; };
      std::vector<Feat> feats;
      Buf fdata_bs, fdata_misc;   // not used; we write directly after FN
      (void)fdata_bs; (void)fdata_misc;
      // first pass collects features into temp arrays so FN precedes
      struct Pay {
        uint8_t code;
        int64_t a, b;            // ints / (base, qual)
        const uint8_t* p;        // byte runs
        int64_t len;
      };
      std::vector<Pay> pays;
      int64_t qpos = 1, rpos = r.pos;
      for (uint32_t ci = 0; ci < r.n_cigar; ci++) {
        uint32_t c = rd_u32(r.cig + 4ull * ci);
        uint32_t op = c & 0xF;
        int64_t ln = c >> 4;
        if ((op == 0 || op == 7 || op == 8) && !have_seq) {
          rpos += ln;
          qpos += ln;
        } else if ((op == 0 || op == 7 || op == 8) && use_ref) {
          for (int64_t k2 = 0; k2 < ln; k2++) {
            int64_t rr = rpos + k2 - (ref_start - 1);
            uint8_t b = seq_buf[(size_t)(qpos - 1 + k2)];
            bool have_rb = rr >= 0 && (uint64_t)rr < ref_len;
            uint8_t rb = have_rb ? ref[rr] : 0;
            if (have_rb && rb == b) continue;
            int sc = have_rb ? sub_code(rb, b) : -1;
            if (sc >= 0) {
              feats.push_back({qpos + k2, 'X'});
              pays.push_back({'X', sc, 0, nullptr, 0});
            } else {
              uint8_t q = (qpos - 1 + k2) < r.l_qseq
                              ? r.qual[qpos - 1 + k2] : 0xFF;
              feats.push_back({qpos + k2, 'B'});
              pays.push_back({'B', b ? b : 0x4E, q, nullptr, 0});
            }
          }
          rpos += ln;
          qpos += ln;
        } else if (op == 0 || op == 7 || op == 8) {
          feats.push_back({qpos, 'b'});
          pays.push_back({'b', 0, 0, seq_buf.data() + (qpos - 1), ln});
          rpos += ln;
          qpos += ln;
        } else if (op == 1) {  // I
          feats.push_back({qpos, 'I'});
          pays.push_back({'I', 0, 0,
                          have_seq ? seq_buf.data() + (qpos - 1) : nullptr,
                          ln});
          qpos += ln;
        } else if (op == 4) {  // S
          feats.push_back({qpos, 'S'});
          pays.push_back({'S', 0, 0,
                          have_seq ? seq_buf.data() + (qpos - 1) : nullptr,
                          ln});
          qpos += ln;
        } else if (op == 2) {  // D
          feats.push_back({qpos, 'D'});
          pays.push_back({'D', ln, 0, nullptr, 0});
          rpos += ln;
        } else if (op == 3) {  // N
          feats.push_back({qpos, 'N'});
          pays.push_back({'N', ln, 0, nullptr, 0});
          rpos += ln;
        } else if (op == 5) {  // H
          feats.push_back({qpos, 'H'});
          pays.push_back({'H', ln, 0, nullptr, 0});
        } else if (op == 6) {  // P
          feats.push_back({qpos, 'P'});
          pays.push_back({'P', ln, 0, nullptr, 0});
        }
      }
      put_itf8(&series[S_FN], (int64_t)feats.size());
      int64_t prev = 0;
      for (size_t fi = 0; fi < feats.size(); fi++) {
        series[S_FC].putc((char)feats[fi].code);
        put_itf8(&series[S_FP], feats[fi].fpos - prev);
        prev = feats[fi].fpos;
        const Pay& pa = pays[fi];
        switch (pa.code) {
          case 'b':
            put_itf8(&series[S_BB_LEN], pa.len);
            series[S_BB].put(pa.p, (size_t)pa.len);
            break;
          case 'I':
            if (pa.p) series[S_IN].put(pa.p, (size_t)pa.len);
            else for (int64_t z = 0; z < pa.len; z++)
              series[S_IN].putc('N');
            series[S_IN].putc('\0');
            break;
          case 'S':
            if (pa.p) series[S_SC].put(pa.p, (size_t)pa.len);
            else for (int64_t z = 0; z < pa.len; z++)
              series[S_SC].putc('N');
            series[S_SC].putc('\0');
            break;
          case 'X':
            series[S_BS].putc((char)pa.a);
            break;
          case 'B':
            series[S_BA].putc((char)pa.a);
            series[S_QS].putc((char)pa.b);
            break;
          case 'D': put_itf8(&series[S_DL], pa.a); break;
          case 'N': put_itf8(&series[S_RS], pa.a); break;
          case 'H': put_itf8(&series[S_HC], pa.a); break;
          case 'P': put_itf8(&series[S_PD], pa.a); break;
        }
      }
      put_itf8(&series[S_MQ], r.mapq);
      if (r.tid == slice_ref && slice_ref >= 0) {
        int64_t e2 = aend(r);
        if (e2 > end_pos) end_pos = e2;
      }
    } else {
      if (r.l_qseq) {
        const char* kNt = "=ACMGRSVTWYHKDBN";
        series[S_BA].reserve((size_t)r.l_qseq);
        uint8_t* dst = series[S_BA].data() + series[S_BA].len();
        for (int64_t k = 0; k < r.l_qseq; k++) {
          uint8_t pk = r.seq[k >> 1];
          dst[k] = (uint8_t)kNt[(k & 1) ? (pk & 0xF) : (pk >> 4)];
        }
        series[S_BA].bump((size_t)r.l_qseq);
      }
    }
    // quals last
    if (r.l_qseq) {
      series[S_QS].put(r.qual, (size_t)r.l_qseq);
      qs_lens.push_back((uint32_t)r.l_qseq);
    } else if (qlen) {
      series[S_QS].reserve((size_t)qlen);
      memset(series[S_QS].data() + series[S_QS].len(), 0xFF, (size_t)qlen);
      series[S_QS].bump((size_t)qlen);
      qs_lens.push_back((uint32_t)qlen);
    } else {
      qs_lens.push_back(0);
    }
  }

  // ---- pack the result ----
  std::vector<std::pair<int32_t, Buf*>> table;
  for (int s = 1; s < S_MAX; s++)
    if (series[s].len()) table.push_back({s, &series[s]});
  // TL is built by python (container-wide dict); skip it even if empty.
  std::vector<uint32_t> tag_kids;
  for (auto& kv : tag_streams) tag_kids.push_back(kv.first);
  std::sort(tag_kids.begin(), tag_kids.end());
  for (uint32_t kid : tag_kids)
    table.push_back({(int32_t)(kTagIdBase + kid), &tag_streams[kid]});

  uint64_t td_total = 0;
  for (auto& l : td_lines) td_total += l.size() + 1;
  uint64_t stream_total = 0;
  for (auto& t : table) stream_total += t.second->len();
  uint64_t hdr_sz = 4 + 8 + 8 + 4 + table.size() * 12 + 4 + 8 + td_total
                    + (uint64_t)n * 8;
  uint8_t* out = (uint8_t*)malloc(hdr_sz + stream_total);
  if (!out) return -1;
  uint8_t* w = out;
  uint32_t u32v = (uint32_t)n;
  memcpy(w, &u32v, 4); w += 4;
  memcpy(w, &nbases, 8); w += 8;
  memcpy(w, &end_pos, 8); w += 8;
  u32v = (uint32_t)table.size();
  memcpy(w, &u32v, 4); w += 4;
  for (auto& t : table) {
    memcpy(w, &t.first, 4); w += 4;
    uint64_t l = t.second->len();
    memcpy(w, &l, 8); w += 8;
  }
  u32v = (uint32_t)td_lines.size();
  memcpy(w, &u32v, 4); w += 4;
  memcpy(w, &td_total, 8); w += 8;
  for (auto& l : td_lines) {
    memcpy(w, l.data(), l.size()); w += l.size();
    *w++ = '\0';
  }
  memcpy(w, rec_tl.data(), (size_t)n * 4); w += (size_t)n * 4;
  memcpy(w, qs_lens.data(), (size_t)n * 4); w += (size_t)n * 4;
  for (auto& t : table) {
    memcpy(w, t.second->data(), t.second->len());
    w += t.second->len();
  }
  *out_ptr = out;
  return (int64_t)(hdr_sz + stream_total);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native mpileup: streaming per-position column builder over a u32-framed
// BAM record stream — the resolve_cigar2 cursor state machine
// (sam.c:5409), overlap-pair quality tweaking (sam.c:5803) and the
// test/pileup.c column format, ported from the golden-tested Python
// engine (htslib_tpu/pileup.py).
// ---------------------------------------------------------------------------

namespace plp {

enum { CMATCH = 0, CINS = 1, CDEL = 2, CREF_SKIP = 3, CSOFT = 4,
       CHARD = 5, CPAD = 6, CEQUAL = 7, CDIFF = 8 };
enum { FPAIRED = 1, FPROPER = 2, FUNMAP = 4, FMUNMAP = 8, FREVERSE = 16,
       FSECONDARY = 256, FQCFAIL = 512, FDUP = 1024 };

static inline bool is_mop(int op) {
  return op == CMATCH || op == CEQUAL || op == CDIFF;
}
static inline bool consumes_ref(int op) {
  return op == CMATCH || op == CDEL || op == CREF_SKIP || op == CEQUAL ||
         op == CDIFF;
}

struct PNode {
  const uint8_t* rec;   // record payload (after block_size)
  uint32_t size;
  int32_t tid, flag, l_qseq, mapq;
  uint32_t n_cigar;
  int64_t pos;
  const uint32_t* cigar;
  const uint8_t* seq4;
  const uint8_t* qualp;
  const char* qname;
  uint32_t qname_len;
  int32_t mtid;
  int64_t mpos, isize;
  int64_t beg, end, s_end;
  // resolve_cigar2 cursor
  int64_t k = -1, x = 0, y = 0;
  std::vector<uint8_t> qual;   // mutable copy for overlap tweaking
  std::vector<char> disp;      // per-base display char (case by strand)
  bool m_only = false;         // single pure-match CIGAR op fast path
};

// per-column per-read state (bam_pileup1_t)
struct PRead {
  PNode* n;
  int64_t qpos = 0;
  int is_del = 0, is_refskip = 0, is_head = 0, is_tail = 0;
  int64_t indel = 0;
  int64_t cigar_ind = 0;
};

static bool parse_rec(const uint8_t* p, uint32_t size, PNode* n) {
  if (size < 32) return false;
  n->rec = p;
  n->size = size;
  n->tid = (int32_t)rd_u32(p + 0);
  n->pos = (int32_t)rd_u32(p + 4);
  uint8_t l_qname = p[8];
  n->mapq = p[9];
  n->n_cigar = rd_u16(p + 12);
  n->flag = rd_u16(p + 14);
  n->l_qseq = (int32_t)rd_u32(p + 16);
  n->mtid = (int32_t)rd_u32(p + 20);
  n->mpos = (int32_t)rd_u32(p + 24);
  n->isize = (int32_t)rd_u32(p + 28);
  n->qname = (const char*)p + 32;
  n->qname_len = l_qname ? l_qname - 1 : 0;
  const uint8_t* cig = p + 32 + l_qname;
  n->cigar = (const uint32_t*)cig;
  n->seq4 = cig + 4ull * n->n_cigar;
  n->qualp = n->seq4 + (n->l_qseq + 1) / 2;
  if (n->qualp + n->l_qseq > p + size) return false;
  // CG long-cigar escape shape: handled by the Python path
  if (n->n_cigar > 0 && n->l_qseq > 0 &&
      n->cigar[0] == (((uint32_t)n->l_qseq << 4) | CSOFT))
    return false;
  int64_t span = 0;
  for (uint32_t k = 0; k < n->n_cigar; k++)
    if (consumes_ref((int)(n->cigar[k] & 0xF))) span += n->cigar[k] >> 4;
  n->beg = n->pos;
  n->end = n->pos + span;
  n->s_end = n->end - 1;
  n->qual.assign(n->qualp, n->qualp + n->l_qseq);
  n->m_only = (n->n_cigar == 1 && is_mop((int)(n->cigar[0] & 0xF)));
  // precompute per-base display chars once per read (emit touches each
  // base once per covered column — ~depth times)
  n->disp.resize(n->l_qseq);
  const char* nt16 = "=ACMGRSVTWYHKDBN";
  uint8_t case_bit = (n->flag & FREVERSE) ? 0x20 : 0;
  for (int32_t i = 0; i < n->l_qseq; i++) {
    uint8_t b4 = n->seq4[i >> 1];
    int nib = (i & 1) == 0 ? (b4 >> 4) : (b4 & 0xF);
    n->disp[i] = (char)(nt16[nib] | case_bit);
  }
  return true;
}

// resolve_cigar2 (sam.c:5409)
static void resolve_cigar2(PRead* p, int64_t pos, PNode* s) {
  const uint32_t* cigar = s->cigar;
  uint32_t n_cigar = s->n_cigar;
  if (s->k == -1) {
    p->qpos = 0;
    if (n_cigar == 1) {
      if (is_mop((int)(cigar[0] & 0xF))) { s->k = 0; s->x = s->pos; s->y = 0; }
    } else {
      s->x = s->pos; s->y = 0;
      uint32_t k = 0;
      for (; k < n_cigar; k++) {
        int op = (int)(cigar[k] & 0xF);
        uint32_t l = cigar[k] >> 4;
        if (consumes_ref(op)) break;
        if (op == CINS || op == CSOFT) s->y += l;
      }
      s->k = k;
    }
  } else {
    int64_t l = cigar[s->k] >> 4;
    if (pos - s->x >= l) {
      int op_cur = (int)(cigar[s->k] & 0xF);
      if (is_mop(op_cur)) s->y += l;
      s->x += l;
      uint32_t k = (uint32_t)s->k + 1;
      for (; k < n_cigar; k++) {
        int op = (int)(cigar[k] & 0xF);
        uint32_t l2 = cigar[k] >> 4;
        if (consumes_ref(op)) break;
        if (op == CINS || op == CSOFT) s->y += l2;
      }
      s->k = k;
    }
  }
  int op = (int)(cigar[s->k] & 0xF);
  int64_t l = cigar[s->k] >> 4;
  p->is_del = 0; p->indel = 0; p->is_refskip = 0;
  if (s->x + l - 1 == pos && (uint32_t)s->k + 1 < n_cigar) {
    int op2 = (int)(cigar[s->k + 1] & 0xF);
    int64_t l2 = cigar[s->k + 1] >> 4;
    if (op2 == CDEL && op != CDEL) {
      p->indel = -l2;
      for (uint32_t k = (uint32_t)s->k + 2; k < n_cigar; k++) {
        int o = (int)(cigar[k] & 0xF);
        int64_t ll = cigar[k] >> 4;
        if (o == CDEL) p->indel -= ll; else break;
      }
    } else if (op2 == CINS) {
      p->indel = l2;
      for (uint32_t k = (uint32_t)s->k + 2; k < n_cigar; k++) {
        int o = (int)(cigar[k] & 0xF);
        int64_t ll = cigar[k] >> 4;
        if (o == CINS) p->indel += ll;
        else if (o != CPAD) break;
      }
    } else if (op2 == CPAD && (uint32_t)s->k + 2 < n_cigar) {
      int64_t l3 = 0;
      for (uint32_t k = (uint32_t)s->k + 2; k < n_cigar; k++) {
        int o = (int)(cigar[k] & 0xF);
        int64_t ll = cigar[k] >> 4;
        if (o == CINS) l3 += ll;
        else if (consumes_ref(o)) break;
      }
      if (l3 > 0) p->indel = l3;
    }
  }
  if (is_mop(op)) {
    p->qpos = s->y + (pos - s->x);
  } else if (op == CDEL || op == CREF_SKIP) {
    p->is_del = 1;
    p->qpos = s->y;
    p->is_refskip = op == CREF_SKIP ? 1 : 0;
  }
  p->is_head = pos == s->pos ? 1 : 0;
  p->is_tail = pos == s->s_end ? 1 : 0;
  p->cigar_ind = s->k;
}

// cigar_iref2iseq_set/next cursor (sam.c:5703 region)
struct CigCur {
  const uint32_t* cigar;
  uint32_t n;
  int64_t ci = 0, icig = 0, iseq = 0, iref = 0;

  int set(int64_t pos) {
    if (pos < 0) return -1;
    icig = iseq = iref = 0;
    while (ci < (int64_t)n) {
      uint32_t c = cigar[ci];
      int op = (int)(c & 0xF);
      int64_t ln = c >> 4;
      if (op == CSOFT) { ci++; iseq += ln; icig = 0; continue; }
      if (op == CHARD || op == CPAD) { ci++; icig = 0; continue; }
      if (is_mop(op)) {
        pos -= ln;
        if (pos < 0) {
          icig = ln + pos;
          iseq += icig;
          iref += icig;
          return CMATCH;
        }
        ci++; iseq += ln; icig = 0; iref += ln;
        continue;
      }
      if (op == CINS) { ci++; iseq += ln; icig = 0; continue; }
      if (op == CDEL || op == CREF_SKIP) {
        pos -= ln;
        if (pos < 0) pos = 0;
        ci++; icig = 0; iref += ln;
        continue;
      }
      return -2;
    }
    iseq = -1;
    return -1;
  }

  int next() {
    while (ci < (int64_t)n) {
      uint32_t c = cigar[ci];
      int op = (int)(c & 0xF);
      int64_t ln = c >> 4;
      if (is_mop(op)) {
        if (icig >= ln - 1) { icig = -1; ci++; continue; }
        iseq++; icig++; iref++;
        return CMATCH;
      }
      if (op == CDEL || op == CREF_SKIP) { ci++; iref += ln; icig = -1; continue; }
      if (op == CINS || op == CSOFT) { ci++; iseq += ln; icig = -1; continue; }
      if (op == CHARD || op == CPAD) { ci++; icig = -1; continue; }
      return -2;
    }
    iseq = -1; iref = -1;
    return -1;
  }

  bool prev_op_is_del() const {
    return ci > 0 && (int)(cigar[ci - 1] & 0xF) == CDEL;
  }
};

static inline uint32_t x31_hash(const char* s, uint32_t n) {
  uint32_t h = 0;
  for (uint32_t i = 0; i < n; i++) h = (h << 5) - h + (uint8_t)s[i];
  return h;
}
static inline uint32_t wang_hash(uint32_t key) {
  key += ~(key << 15);
  key ^= key >> 10;
  key += key << 3;
  key ^= key >> 6;
  key += ~(key << 11);
  key ^= key >> 16;
  return key;
}

static inline int seq_nib(const uint8_t* s4, int64_t i) {
  uint8_t b = s4[i >> 1];
  return (i & 1) == 0 ? (b >> 4) : (b & 0xF);
}

// tweak_overlap_quality (sam.c:5803)
static int tweak_overlap(PNode* na, PNode* nb) {
  CigCur ca{na->cigar, na->n_cigar};
  CigCur cb{nb->cigar, nb->n_cigar};
  int64_t iref = nb->pos;
  int a_ret = ca.set(iref - na->pos);
  if (a_ret < 0) return a_ret < -1 ? -1 : 0;
  int b_ret = cb.set(iref - nb->pos);
  if (b_ret < 0) return b_ret < -1 ? -1 : 0;
  int amul, bmul;
  if (wang_hash(x31_hash(na->qname, na->qname_len)) & 1) { amul = 1; bmul = 0; }
  else { amul = 0; bmul = 1; }
  while (true) {
    while (a_ret >= 0 && ca.iref >= 0 && ca.iref < iref - na->pos)
      a_ret = ca.next();
    if (a_ret < 0) return a_ret < -1 ? -1 : 0;
    while (b_ret >= 0 && cb.iref >= 0 && cb.iref < iref - nb->pos)
      b_ret = cb.next();
    if (b_ret < 0) return b_ret < -1 ? -1 : 0;
    if (iref < ca.iref + na->pos) iref = ca.iref + na->pos;
    if (iref < cb.iref + nb->pos) iref = cb.iref + nb->pos;
    iref++;
    if (ca.iref + na->pos != cb.iref + nb->pos) {
      if (ca.iref + na->pos < cb.iref + nb->pos && cb.prev_op_is_del()) {
        while (true) {
          na->qual[ca.iseq] = amul ? (uint8_t)(na->qual[ca.iseq] * 0.8) : 0;
          a_ret = ca.next();
          if (a_ret < 0) return a_ret < -1 ? -1 : 0;
          if (!(ca.iref + na->pos < cb.iref + nb->pos)) break;
        }
      } else if (cb.iref + nb->pos < ca.iref + na->pos && ca.prev_op_is_del()) {
        while (true) {
          nb->qual[cb.iseq] = bmul ? (uint8_t)(nb->qual[cb.iseq] * 0.8) : 0;
          b_ret = cb.next();
          if (b_ret < 0) return b_ret < -1 ? -1 : 0;
          if (!(cb.iref + nb->pos < ca.iref + na->pos)) break;
        }
      } else {
        continue;
      }
    }
    if (ca.iseq > na->l_qseq || cb.iseq > nb->l_qseq) return -1;
    if (seq_nib(na->seq4, ca.iseq) == seq_nib(nb->seq4, cb.iseq)) {
      int q = na->qual[ca.iseq] + nb->qual[cb.iseq];
      if (q > 200) q = 200;
      na->qual[ca.iseq] = (uint8_t)(amul * q);
      nb->qual[cb.iseq] = (uint8_t)(bmul * q);
    } else {
      if (na->qual[ca.iseq] > nb->qual[cb.iseq]) {
        na->qual[ca.iseq] = (uint8_t)(0.8 * na->qual[ca.iseq]);
        nb->qual[cb.iseq] = 0;
      } else if (na->qual[ca.iseq] < nb->qual[cb.iseq]) {
        nb->qual[cb.iseq] = (uint8_t)(0.8 * nb->qual[cb.iseq]);
        na->qual[ca.iseq] = 0;
      } else {
        na->qual[ca.iseq] = (uint8_t)(amul * (int)(0.8 * na->qual[ca.iseq]));
        nb->qual[cb.iseq] = (uint8_t)(bmul * (int)(0.8 * nb->qual[cb.iseq]));
      }
    }
  }
}

}  // namespace plp

extern "C" {

// Pileup text (test/pileup.c format) over a u32-framed BAM record
// stream.  skip_mask records are dropped (readaln, test/pileup.c:62).
// Only columns with (lo_tid,lo_pos) <= (tid,pos) < (hi_tid,hi_pos) are
// emitted — the coordinate-tile window for sharded mpileup (halo reads
// are still processed so overlap tweaking stays exact; the bounds only
// gate emission).  Returns output bytes via *out_ptr (htstpu_buf_free),
// -100 = bail (CG-escape record etc.: caller uses the Python engine),
// -2 = unsorted.
int64_t htstpu_mpileup(const uint8_t* data, uint64_t data_len,
                       const uint8_t* name_buf, const uint64_t* name_offs,
                       const uint32_t* name_lens, int32_t n_ref,
                       int32_t skip_mask, int32_t enable_overlaps,
                       int32_t lo_tid, int64_t lo_pos,
                       int32_t hi_tid, int64_t hi_pos,
                       uint8_t** out_ptr) {
  using namespace plp;
  auto in_window = [&](int32_t tid, int64_t pos) -> bool {
    if (tid < lo_tid || (tid == lo_tid && pos < lo_pos)) return false;
    if (tid > hi_tid || (tid == hi_tid && pos >= hi_pos)) return false;
    return true;
  };
  std::vector<std::unique_ptr<PNode>> pool;
  std::vector<PNode*> nodes;
  std::unordered_map<std::string, PNode*> overlaps;

  int32_t cur_tid = -1;
  int64_t cur_pos = 0;
  int32_t max_tid = -1;
  int64_t max_pos = -1;
  bool eof = false;
  uint64_t dp = 0;
  Buf out;
  std::string ins_tmp;

  auto read_next = [&](PNode** np) -> int {
    // pull the next kept record from the stream; 0 = got one, 1 = EOF,
    // -100 = bail
    while (dp + 4 <= data_len) {
      uint32_t bs = rd_u32(data + dp);
      if (dp + 4 + bs > data_len) return -100;
      const uint8_t* rp = data + dp + 4;
      dp += 4ull + bs;
      auto n = std::make_unique<PNode>();
      if (!parse_rec(rp, bs, n.get())) return -100;
      if (n->flag & skip_mask) continue;
      *np = n.get();
      pool.push_back(std::move(n));
      return 0;
    }
    return 1;
  };

  auto overlap_remove = [&](PNode* b) {
    if (!enable_overlaps) return;
    if (!b) { overlaps.clear(); return; }
    if (!((b->flag & FUNMAP) || !(b->flag & FPROPER)))
      overlaps.erase(std::string(b->qname, b->qname_len));
  };

  auto overlap_push = [&](PNode* node) -> int {
    if (!enable_overlaps) return 0;
    PNode* b = node;
    if ((b->flag & FMUNMAP) || !(b->flag & FPROPER)) return 0;
    if ((b->mtid >= 0 && b->tid != b->mtid) ||
        (std::llabs((long long)b->isize) >= 2 * (int64_t)b->l_qseq &&
         b->mpos >= node->end))
      return 0;
    std::string key(b->qname, b->qname_len);
    auto it = overlaps.find(key);
    if (it == overlaps.end()) {
      if (b->mpos >= b->pos || ((b->flag & FPAIRED) && b->mpos == -1))
        overlaps.emplace(std::move(key), node);
      return 0;
    }
    int err = tweak_overlap(it->second, node);
    overlaps.erase(it);
    return err;
  };

  int64_t n_complex = 0;   // active nodes needing the resolve cursor
  auto push = [&](PNode* b) -> int {
    if (!b) { eof = true; return 0; }
    if (b->tid < 0 || (b->flag & FUNMAP)) { overlap_remove(b); return 0; }
    if (b->tid < max_tid) return -2;
    if (b->tid == max_tid && b->beg < max_pos) return -2;
    max_tid = b->tid;
    max_pos = b->beg;
    if (b->end > cur_pos || b->tid > cur_tid) {
      if (overlap_push(b) < 0) return -2;
      nodes.push_back(b);
      if (!b->m_only) n_complex++;
    }
    return 0;
  };

  std::vector<PRead> plp_col;
  std::string base_tmp, qual_tmp;
  auto advance_cursor = [&]() -> int {
    if (!nodes.empty()) {
      PNode* head = nodes[0];
      if (cur_tid > head->tid) return -2;
      if (cur_tid < head->tid) { cur_tid = head->tid; cur_pos = head->beg; }
      else if (cur_pos < head->beg) cur_pos = head->beg;
      else cur_pos++;
    } else {
      cur_pos++;
    }
    return 0;
  };
  auto next_column = [&](int32_t* otid, int64_t* opos) -> int {
    // 1 = column in plp_col, 0 = need more input / done, -2 = error;
    // columns of pure-match reads are scanned AND written in one pass
    // (no per-column PRead materialisation) and never returned
    if (eof && nodes.empty()) return 0;
    while (eof || max_tid > cur_tid ||
           (max_tid == cur_tid && max_pos > cur_pos)) {
      if (n_complex == 0) {
        // fused scan+emit: every active read is a single pure-match
        // op, so qpos/is_head/is_tail are arithmetic and the display
        // char is precomputed — build the base and qual rows directly
        base_tmp.clear();
        qual_tmp.clear();
        size_t w = 0;
        for (size_t i = 0; i < nodes.size(); i++) {
          PNode* node = nodes[i];
          if (node->tid < cur_tid ||
              (node->tid == cur_tid && node->end <= cur_pos)) {
            overlap_remove(node);
            continue;
          }
          if (node->tid == cur_tid && node->beg <= cur_pos) {
            int64_t qpos = cur_pos - node->pos;
            if (cur_pos == node->pos) {
              base_tmp.push_back('^');
              base_tmp.push_back(
                  (char)('!' + (node->mapq < 93 ? node->mapq : 93)));
            }
            base_tmp.push_back(node->disp[qpos]);
            if (cur_pos == node->s_end) base_tmp.push_back('$');
            int q = node->qual[qpos] + 33;
            qual_tmp.push_back(q < (int)'~' ? (char)q : '~');
          }
          nodes[w++] = node;
        }
        nodes.resize(w);
        int32_t tid = cur_tid;
        int64_t pos = cur_pos;
        if (advance_cursor() < 0) return -2;
        if (!qual_tmp.empty() && in_window(tid, pos)) {
          uint32_t nml = (tid >= 0 && tid < n_ref) ? name_lens[tid] : 1;
          out.reserve((size_t)nml + 48 + base_tmp.size() +
                      qual_tmp.size());
          uint8_t* w0 = out.end_ptr();
          uint8_t* wp = w0;
          if (tid >= 0 && tid < n_ref) {
            memcpy(wp, name_buf + name_offs[tid], nml);
            wp += nml;
          } else {
            *wp++ = '*';
          }
          *wp++ = '\t';
          wp = Buf::write_i64(wp, pos + 1);
          *wp++ = '\t';
          wp = Buf::write_i64(wp, (int64_t)qual_tmp.size());
          *wp++ = '\t';
          memcpy(wp, base_tmp.data(), base_tmp.size());
          wp += base_tmp.size();
          *wp++ = '\t';
          memcpy(wp, qual_tmp.data(), qual_tmp.size());
          wp += qual_tmp.size();
          *wp++ = '\n';
          out.bump((size_t)(wp - w0));
        }
        if (eof && nodes.empty()) break;
        continue;
      }
      plp_col.clear();
      size_t w = 0;
      for (size_t i = 0; i < nodes.size(); i++) {
        PNode* node = nodes[i];
        if (node->tid < cur_tid ||
            (node->tid == cur_tid && node->end <= cur_pos)) {
          overlap_remove(node);
          if (!node->m_only) n_complex--;
          continue;
        }
        if (node->tid == cur_tid && node->beg <= cur_pos) {
          PRead p;
          p.n = node;
          if (node->m_only) {
            // single pure-match op: resolve_cigar2 degenerates to this
            p.qpos = cur_pos - node->pos;
            p.is_head = cur_pos == node->pos ? 1 : 0;
            p.is_tail = cur_pos == node->s_end ? 1 : 0;
          } else {
            resolve_cigar2(&p, cur_pos, node);
          }
          plp_col.push_back(p);
        }
        nodes[w++] = node;
      }
      nodes.resize(w);
      int32_t tid = cur_tid;
      int64_t pos = cur_pos;
      if (advance_cursor() < 0) return -2;
      if (!plp_col.empty()) { *otid = tid; *opos = pos; return 1; }
      if (eof && nodes.empty()) break;
    }
    return 0;
  };

  auto emit = [&](int32_t tid, int64_t pos) {
    // fast writer for indel-free columns (the overwhelmingly common
    // case): one reservation, raw-pointer writes, precomputed base
    // chars.  Indel columns use the general putc path below.
    bool has_indel = false;
    for (auto& p : plp_col)
      if (p.indel != 0) { has_indel = true; break; }
    if (!has_indel) {
      uint32_t nml = (tid >= 0 && tid < n_ref) ? name_lens[tid] : 1;
      out.reserve((size_t)nml + 48 + plp_col.size() * 5);
      uint8_t* w0 = out.end_ptr();
      uint8_t* w = w0;
      if (tid >= 0 && tid < n_ref) {
        memcpy(w, name_buf + name_offs[tid], nml);
        w += nml;
      } else {
        *w++ = '*';
      }
      *w++ = '\t';
      w = Buf::write_i64(w, pos + 1);
      *w++ = '\t';
      w = Buf::write_i64(w, (int64_t)plp_col.size());
      *w++ = '\t';
      for (auto& p : plp_col) {
        PNode* b = p.n;
        if (p.is_head) {
          *w++ = '^';
          *w++ = (char)('!' + (b->mapq < 93 ? b->mapq : 93));
        }
        if (p.is_del)
          *w++ = p.is_refskip ? ((b->flag & FREVERSE) ? '<' : '>') : '*';
        else
          *w++ = b->disp[p.qpos];
        if (p.is_tail) *w++ = '$';
      }
      *w++ = '\t';
      for (auto& p : plp_col) {
        char q = '~';
        if (p.qpos < p.n->l_qseq && p.n->qual[p.qpos] + 33 < (int)'~')
          q = (char)(p.n->qual[p.qpos] + 33);
        *w++ = q;
      }
      *w++ = '\n';
      out.bump((size_t)(w - w0));
      return;
    }
    if (tid >= 0 && tid < n_ref)
      out.put(name_buf + name_offs[tid], name_lens[tid]);
    else
      out.putc('*');
    out.putc('\t');
    out.put_i64(pos + 1);
    out.putc('\t');
    out.put_i64((int64_t)plp_col.size());
    out.putc('\t');
    for (auto& p : plp_col) {
      PNode* b = p.n;
      bool rev = (b->flag & FREVERSE) != 0;
      if (p.is_head) {
        out.putc('^');
        out.putc((char)('!' + (b->mapq < 93 ? b->mapq : 93)));
      }
      if (p.is_del) {
        out.putc(p.is_refskip ? (rev ? '<' : '>') : '*');
      } else {
        out.putc(b->disp[p.qpos]);
      }
      int64_t del_len = 0;
      if (p.indel > 0) {
        // bam_plp_insertion (sam.c:5517)
        ins_tmp.clear();
        int64_t j = 1;
        for (int64_t k = p.cigar_ind + 1; k < (int64_t)b->n_cigar; k++) {
          int op = (int)(b->cigar[k] & 0xF);
          int64_t ln = b->cigar[k] >> 4;
          if (op == CPAD) {
            ins_tmp.append((size_t)ln, '*');
          } else if (op == CINS) {
            for (int64_t z = 0; z < ln; z++) {
              int64_t qp = p.qpos + j - p.is_del;
              char c = qp < b->l_qseq ? kNt16[seq_nib(b->seq4, qp)] : 'N';
              ins_tmp.push_back(rev ? (char)tolower(c) : (char)toupper(c));
              j++;
            }
          } else {
            if (op == CDEL) del_len = ln;
            break;
          }
        }
        out.putc('+');
        out.put_i64((int64_t)ins_tmp.size());
        out.putc('(');
        out.put(ins_tmp.data(), ins_tmp.size());
        out.putc(')');
      } else {
        del_len = -p.indel;
      }
      if (del_len > 0) {
        out.putc('-');
        out.put_i64(del_len);
        out.put("()", 2);
      }
      if (p.is_tail) out.putc('$');
    }
    out.putc('\t');
    for (auto& p : plp_col) {
      char q = '~';
      if (p.qpos < p.n->l_qseq && p.n->qual[p.qpos] + 33 < (int)'~')
        q = (char)(p.n->qual[p.qpos] + 33);
      out.putc(q);
    }
    out.putc('\n');
  };

  while (true) {
    int32_t tid;
    int64_t pos;
    int r = next_column(&tid, &pos);
    if (r == -2) return -2;
    if (r == 1) {
      if (in_window(tid, pos)) emit(tid, pos);
      continue;
    }
    if (eof) break;
    PNode* b = nullptr;
    int rr = read_next(&b);
    if (rr == -100) return -100;
    if (rr == 1) {
      if (push(nullptr) < 0) return -2;
    } else if (push(b) < 0) {
      return -2;
    }
  }

  uint8_t* res = (uint8_t*)malloc(out.len() ? out.len() : 1);
  if (!res) return -1;
  memcpy(res, out.data(), out.len());
  *out_ptr = res;
  return (int64_t)out.len();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native BCF->VCF formatter: typed-value decode + vcf_format text
// assembly (vcf.c:4304) over the uncompressed BCF body ([u32 l_shared]
// [u32 l_indiv][shared][indiv] frames).  Semantics ported from the
// golden-tested Python model (htslib_tpu/vcf/record.py to_vcf).
// ---------------------------------------------------------------------------

namespace bcf {

enum { BT_NULL = 0, BT_INT8 = 1, BT_INT16 = 2, BT_INT32 = 3, BT_INT64 = 4,
       BT_FLOAT = 5, BT_CHAR = 7 };
static const int32_t I8_MISS = -128, I8_END = -127;
static const int32_t I16_MISS = -32768, I16_END = -32767;
static const int32_t I32_MISS = INT32_MIN, I32_END = INT32_MIN + 1;
static const uint32_t F_MISS = 0x7F800001u, F_END = 0x7F800002u;

static inline int bt_shift(int bt) {
  switch (bt) {
    case BT_INT16: return 1;
    case BT_INT32: case BT_FLOAT: return 2;
    case BT_INT64: return 3;
    default: return 0;
  }
}

struct Cur {
  const uint8_t* p;
  const uint8_t* e;
  bool fail = false;

  bool dec_size(int64_t* n, int* bt) {
    if (p >= e) { fail = true; return false; }
    uint8_t d = *p++;
    *bt = d & 0xF;
    int64_t nn = d >> 4;
    if (nn == 15) {
      int64_t sn; int sbt;
      if (!dec_size(&sn, &sbt)) return false;
      // scalar int follows
      if (sbt == BT_INT8) { nn = (int8_t)*p; p += 1; }
      else if (sbt == BT_INT16) { nn = (int16_t)rd_u16(p); p += 2; }
      else if (sbt == BT_INT32) { nn = (int32_t)rd_u32(p); p += 4; }
      else { fail = true; return false; }
    }
    *n = nn;
    return true;
  }

  int64_t scalar_int() {
    int64_t n; int bt;
    if (!dec_size(&n, &bt)) return 0;
    int64_t v = 0;
    if (bt == BT_INT8) { v = (int8_t)*p; p += 1; }
    else if (bt == BT_INT16) { v = (int16_t)rd_u16(p); p += 2; }
    else if (bt == BT_INT32) { v = (int32_t)rd_u32(p); p += 4; }
    else fail = true;
    return v;
  }
};

static inline int32_t widen(const uint8_t* p, int bt, int64_t i) {
  if (bt == BT_INT8) {
    int32_t v = (int8_t)p[i];
    if (v == I8_MISS) return I32_MISS;
    if (v == I8_END) return I32_END;
    return v;
  }
  if (bt == BT_INT16) {
    int32_t v = (int16_t)rd_u16(p + 2 * i);
    if (v == I16_MISS) return I32_MISS;
    if (v == I16_END) return I32_END;
    return v;
  }
  return (int32_t)rd_u32(p + 4 * i);
}

// NOTE: every fmt_* helper below writes through a raw cursor; the
// caller (fmt_record) reserves the record's worst-case text up front
// and commits the final length once.
static uint8_t* put_g(uint8_t* w, uint32_t bits) {
  float f;
  memcpy(&f, &bits, 4);
  // fast path for integral values in %g's plain-notation range (the
  // common QUAL/PL case): avoids snprintf.  %g flips to exponent
  // notation at 1e6, and -0.0 prints "-0", so both are excluded; the
  // range check also rejects NaN/inf before the cast.
  if (f > -1e6f && f < 1e6f && bits != 0x80000000u) {
    int64_t iv = (int64_t)f;
    if ((float)iv == f) return Buf::write_i64(w, iv);
  }
  return w + snprintf((char*)w, 40, "%g", (double)f);
}

// bcf_fmt_array int leg (vcf.c:3036 / record.py _fmt_int_arr)
static uint8_t* fmt_int_arr(uint8_t* w, const uint8_t* p, int bt,
                            int64_t n) {
  int any = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t v = widen(p, bt, i);
    if (v == I32_END) break;
    if (any) *w++ = ',';
    if (v == I32_MISS) *w++ = '.';
    else w = Buf::write_i64(w, v);
    any++;
  }
  if (!any && n == 0) *w++ = '.';
  return w;
}

static uint8_t* fmt_float_arr(uint8_t* w, const uint8_t* p, int64_t n) {
  int any = 0;
  for (int64_t i = 0; i < n; i++) {
    uint32_t b = rd_u32(p + 4 * i);
    if (b == F_END) break;
    if (any) *w++ = ',';
    if (b == F_MISS) *w++ = '.';
    else w = put_g(w, b);
    any++;
  }
  if (!any && n == 0) *w++ = '.';
  return w;
}

static uint8_t* fmt_char_arr(uint8_t* w, const uint8_t* p, int64_t n) {
  if (n == 0) { *w++ = '.'; return w; }
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = p[i];
    if (c == 0) break;
    *w++ = (c == 0x07 ? '.' : (char)c);
  }
  return w;
}

// bcf_format_gt_v2 (vcf.c:6345 / record.py _fmt_gt).  With v44, emit a
// first-allele phasing prefix only when the reader's inference would
// otherwise get it wrong (vcf.c:6382).
static uint8_t* fmt_gt(uint8_t* w, const uint8_t* p, int bt, int64_t n,
                       bool v44) {
  if (v44) {
    int32_t val0 = 0;
    int ploidy = 0;
    bool anyunphased = false;
    for (int64_t i = 0; i < n; i++) {
      int32_t v = widen(p, bt, i);
      if (v == I32_END) break;
      if (!i) val0 = v;
      else anyunphased |= !(v & 1);
      ploidy++;
    }
    if (ploidy) {
      if (val0 & 1) {
        if ((ploidy > 1 && anyunphased) || (ploidy <= 1 && !(val0 >> 1)))
          *w++ = '|';
      } else {
        if ((ploidy <= 1 && val0 != 0) || (ploidy > 1 && !anyunphased))
          *w++ = '/';
      }
    }
  }
  int any = 0;
  for (int64_t i = 0; i < n; i++) {
    int32_t v = widen(p, bt, i);
    if (v == I32_END) break;
    if (i) *w++ = (v & 1) ? '|' : '/';
    int32_t al = v >> 1;
    if (al == 0) *w++ = '.';
    else w = Buf::write_i64(w, al - 1);
    any++;
  }
  if (!any) *w++ = '.';
  return w;
}

}  // namespace bcf

struct VcfTables {
  const uint8_t* ctg_buf; const uint64_t* ctg_offs;
  const uint32_t* ctg_lens; int32_t n_ctg;
  const uint8_t* id_buf; const uint64_t* id_offs;
  const uint32_t* id_lens; int32_t n_id;
  int32_t gt_id;
  int32_t v44 = 0;  // VCF >= 4.4: explicit GT first-allele phasing
  // worst-case per-wire-byte text expansion: the densest cases are an
  // int8 value ("-120," = 5 chars/byte) and a FILTER id (one int8 byte
  // -> longest dictionary name + ';').  Floats are bounded by put_g's
  // 40-char tmp over 4 wire bytes.
  uint32_t max_id_len = 0, max_ctg_len = 0, per_byte = 12;
};

struct FmtDesc { int64_t key; int bt; int64_t nper; const uint8_t* p; };

// Format one BCF record (shared+indiv blobs) as one VCF line + \n.
// `fds` is caller-owned scratch (reused across records, no per-record
// allocation).
static bool fmt_record(const uint8_t* sh, uint32_t l_shared,
                       const uint8_t* iv, uint32_t l_indiv,
                       const VcfTables& T, Buf& out,
                       std::vector<FmtDesc>& fds) {
  using namespace bcf;
  int32_t n_ctg = T.n_ctg;
  int32_t gt_id = T.gt_id;
  {
    if (l_shared < 24) return false;
    int32_t rid = (int32_t)rd_u32(sh + 0);
    int64_t pos = (int32_t)rd_u32(sh + 4);
    uint32_t qual_bits = rd_u32(sh + 12);
    uint32_t n_ai = rd_u32(sh + 16);
    uint32_t n_fs = rd_u32(sh + 20);
    uint32_t n_info = n_ai & 0xFFFF;
    uint32_t n_allele = n_ai >> 16;
    uint32_t n_sample = n_fs & 0xFFFFFF;
    uint32_t n_fmt = n_fs >> 24;

    // one reservation for the whole line, then raw-cursor writes: the
    // bound covers typed values (per_byte per wire byte), zero-width
    // fields (".:" per sample/field), FORMAT keys and fixed columns
    out.reserve((uint64_t)(l_shared + l_indiv) * T.per_byte +
                T.max_ctg_len +
                (uint64_t)n_sample * (2ull * n_fmt + 4) +
                (uint64_t)n_fmt * (T.max_id_len + 2) + 128);
    uint8_t* w0 = out.end_ptr();
    uint8_t* w = w0;
    auto put_id = [&](int64_t i) {
      if (i >= 0 && i < T.n_id) {
        memcpy(w, T.id_buf + T.id_offs[i], T.id_lens[i]);
        w += T.id_lens[i];
      } else {
        *w++ = '.';
      }
    };

    // CHROM POS
    if (rid >= 0 && rid < n_ctg) {
      memcpy(w, T.ctg_buf + T.ctg_offs[rid], T.ctg_lens[rid]);
      w += T.ctg_lens[rid];
    } else {
      *w++ = '.';
    }
    *w++ = '\t';
    w = Buf::write_i64(w, pos + 1);
    *w++ = '\t';

    Cur c{sh + 24, sh + l_shared};
    int64_t n; int bt;
    // ID
    if (!c.dec_size(&n, &bt)) return false;
    if (bt == BT_CHAR && n > 0) { memcpy(w, c.p, n); w += n; }
    else *w++ = '.';
    c.p += n << bt_shift(bt);
    // REF / ALT
    for (uint32_t a = 0; a < n_allele; a++) {
      if (!c.dec_size(&n, &bt)) return false;
      if (a == 0) {
        *w++ = '\t';
        memcpy(w, c.p, n); w += n;
        *w++ = '\t';
      } else {
        if (a > 1) *w++ = ',';
        memcpy(w, c.p, n); w += n;
      }
      c.p += n << bt_shift(bt);
    }
    if (n_allele == 0) { memcpy(w, "\t.\t.", 4); w += 4; }
    else if (n_allele == 1) *w++ = '.';
    // QUAL
    *w++ = '\t';
    if (qual_bits == F_MISS) *w++ = '.';
    else w = put_g(w, qual_bits);
    *w++ = '\t';
    // FILTER
    if (!c.dec_size(&n, &bt)) return false;
    if (n == 0) *w++ = '.';
    else {
      for (int64_t i = 0; i < n; i++) {
        if (i) *w++ = ';';
        put_id(widen(c.p, bt, i));
      }
    }
    c.p += n << bt_shift(bt);
    // INFO
    *w++ = '\t';
    if (n_info == 0) *w++ = '.';
    for (uint32_t i = 0; i < n_info; i++) {
      if (i) *w++ = ';';
      int64_t key = c.scalar_int();
      if (!c.dec_size(&n, &bt)) return false;
      put_id(key);
      if (bt == BT_NULL) { /* FLAG */ }
      else if (bt == BT_CHAR) { *w++ = '='; memcpy(w, c.p, n); w += n; }
      else if (bt == BT_FLOAT) { *w++ = '='; w = fmt_float_arr(w, c.p, n); }
      else { *w++ = '='; w = fmt_int_arr(w, c.p, bt, n); }
      c.p += n << bt_shift(bt);
    }
    if (c.fail) return false;
    // FORMAT + samples
    if (n_fmt) {
      Cur f{iv, iv + l_indiv};
      fds.clear();
      for (uint32_t i = 0; i < n_fmt; i++) {
        int64_t key = f.scalar_int();
        int64_t nper; int fbt;
        if (!f.dec_size(&nper, &fbt)) return false;
        fds.push_back({key, fbt, nper, f.p});
        f.p += (nper * n_sample) << bt_shift(fbt);
      }
      if (f.fail || f.p > f.e) return false;
      *w++ = '\t';
      for (uint32_t i = 0; i < n_fmt; i++) {
        if (i) *w++ = ':';
        put_id(fds[i].key);
      }
      for (uint32_t s = 0; s < n_sample; s++) {
        *w++ = '\t';
        for (uint32_t i = 0; i < n_fmt; i++) {
          if (i) *w++ = ':';
          const FmtDesc& fd = fds[i];
          const uint8_t* vp = fd.p + ((fd.nper * s) << bt_shift(fd.bt));
          if (fd.key == gt_id && fd.bt != BT_FLOAT && fd.bt != BT_CHAR)
            w = fmt_gt(w, vp, fd.bt, fd.nper, T.v44 != 0);
          else if (fd.bt == BT_FLOAT)
            w = fmt_float_arr(w, vp, fd.nper);
          else if (fd.bt == BT_CHAR)
            w = fmt_char_arr(w, vp, fd.nper);
          else
            w = fmt_int_arr(w, vp, fd.bt, fd.nper);
        }
        if (n_fmt == 0) *w++ = '.';
      }
    } else if (n_sample) {
      for (uint32_t s = 0; s < n_sample + 1; s++) {
        memcpy(w, "\t.", 2); w += 2;
      }
    }
    *w++ = '\n';
    out.bump((size_t)(w - w0));
  }
  return true;
}

extern "C" {

// Format BCF records as VCF text, multithreaded by record ranges.
// Inputs: the uncompressed BCF body (concatenated l_shared/l_indiv-
// framed records), contig-name and dictionary-id string tables, and the
// GT key id.  Returns bytes via *out_ptr (htstpu_buf_free),
// -(5000+i) on malformed record i.
int64_t htstpu_bcf_to_vcf(const uint8_t* data, uint64_t data_len,
                          const uint8_t* ctg_buf, const uint64_t* ctg_offs,
                          const uint32_t* ctg_lens, int32_t n_ctg,
                          const uint8_t* id_buf, const uint64_t* id_offs,
                          const uint32_t* id_lens, int32_t n_id,
                          int32_t gt_id, int32_t v44, uint8_t** out_ptr) {
  VcfTables T{ctg_buf, ctg_offs, ctg_lens, n_ctg,
              id_buf, id_offs, id_lens, n_id, gt_id, v44};
  for (int32_t i = 0; i < n_id; i++)
    if (id_lens[i] > T.max_id_len) T.max_id_len = id_lens[i];
  for (int32_t i = 0; i < n_ctg; i++)
    if (ctg_lens[i] > T.max_ctg_len) T.max_ctg_len = ctg_lens[i];
  // a FILTER entry is one int8 wire byte expanding to a full id + ';'
  if (T.max_id_len + 2 > T.per_byte) T.per_byte = T.max_id_len + 2;
  // frame walk (cheap): record offsets
  std::vector<uint64_t> offs;
  uint64_t dp = 0;
  while (dp + 8 <= data_len) {
    uint32_t l_shared = rd_u32(data + dp);
    uint32_t l_indiv = rd_u32(data + dp + 4);
    if (dp + 8ull + l_shared + l_indiv > data_len)
      return -(5000 + (int64_t)offs.size());
    offs.push_back(dp);
    dp += 8ull + l_shared + l_indiv;
  }
  if (dp != data_len) return -(5000 + (int64_t)offs.size());
  int64_t n = (int64_t)offs.size();

  int nthreads = hardware_threads();
  int shards = nthreads * 4;
  if (shards > n) shards = n ? (int)n : 1;
  std::vector<Buf> bufs(shards);
  std::atomic<int64_t> err(0);
  int64_t per = (n + shards - 1) / (shards ? shards : 1);
  parallel_for(shards, nthreads, [&](int64_t si) {
    int64_t lo = si * per, hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) return;
    uint64_t end_b = hi < n ? offs[hi] : data_len;
    bufs[si].reserve((end_b - offs[lo]) * 3 + 4096);
    std::vector<FmtDesc> fds;
    for (int64_t i = lo; i < hi; i++) {
      const uint8_t* p = data + offs[i];
      uint32_t l_shared = rd_u32(p);
      uint32_t l_indiv = rd_u32(p + 4);
      if (!fmt_record(p + 8, l_shared, p + 8 + l_shared, l_indiv, T,
                      bufs[si], fds)) {
        err.store(-(5000 + i), std::memory_order_relaxed);
        return;
      }
    }
  });
  if (err.load()) return err.load();
  int64_t total = 0;
  for (auto& b : bufs) total += b.len();
  uint8_t* res = (uint8_t*)malloc(total ? total : 1);
  if (!res) return -1;
  std::vector<int64_t> starts(shards);
  int64_t pos = 0;
  for (int i = 0; i < shards; i++) { starts[i] = pos; pos += bufs[i].len(); }
  parallel_for(shards, nthreads, [&](int64_t si) {
    memcpy(res + starts[si], bufs[si].data(), bufs[si].len());
  });
  *out_ptr = res;
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native VCF text parser: VCF body lines -> BCF record frames
// (vcf_parse, vcf.c:3987; typed encode vcf.c:2834 bcf_enc_*).  Byte-
// identical to the Python model (vcf/record.py from_vcf + to_bcf).
// Records that need header mutation or exotic handling set a bail flag
// and are re-parsed by Python, spliced back in order.
// ---------------------------------------------------------------------------

namespace vcfp {

enum { BT_NULL = 0, BT_INT8 = 1, BT_INT16 = 2, BT_INT32 = 3,
       BT_FLOAT = 5, BT_CHAR = 7 };
enum { HT_FLAG = 0, HT_INT = 1, HT_REAL = 2, HT_STR = 3 };
static const int32_t I32_MISS = INT32_MIN, I32_END = INT32_MIN + 1;
static const uint32_t F_MISS = 0x7F800001u, F_END = 0x7F800002u;

struct Tables {
  // id dictionary: name -> id, with per-context HT types
  std::unordered_map<std::string, int32_t> ids;
  std::vector<int32_t> flt_def, info_type, fmt_type;  // -1 = undefined
  std::unordered_map<std::string, int32_t> ctgs;
  int32_t gt_id = -1, end_id = -1;
};

static inline void enc_typed_int(Buf& out, int64_t x) {
  if (x == I32_END) { out.putc((char)(1 << 4 | BT_INT8)); out.putc((char)-127); }
  else if (x == I32_MISS) { out.putc((char)(1 << 4 | BT_INT8)); out.putc((char)-128); }
  else if (x >= -120 && x <= 127) {
    out.putc((char)(1 << 4 | BT_INT8)); out.putc((char)(int8_t)x);
  } else if (x >= -32760 && x <= 32767) {
    out.putc((char)(1 << 4 | BT_INT16));
    uint16_t v = (uint16_t)(int16_t)x; out.put(&v, 2);
  } else {
    out.putc((char)(1 << 4 | BT_INT32));
    uint32_t v = (uint32_t)(int32_t)x; out.put(&v, 4);
  }
}

static inline void enc_size(Buf& out, int64_t size, int bt) {
  if (size >= 15) {
    out.putc((char)(15 << 4 | bt));
    enc_typed_int(out, size);
  } else {
    out.putc((char)(size << 4 | bt));
  }
}

static void enc_vint(Buf& out, const std::vector<int64_t>& a,
                     int64_t wsize = -1) {
  int64_t n = (int64_t)a.size();
  if (n <= 0) { enc_size(out, 0, BT_NULL); return; }
  if (n == 1) { enc_typed_int(out, a[0]); return; }
  if (wsize <= 0) wsize = n;
  int64_t mx = INT64_MIN, mn = (1LL << 31) - 1;
  bool any = false;
  for (int64_t v : a) {
    if (v > mx) mx = v;
    if (v > I32_END && v < mn) { mn = v; any = true; }
  }
  (void)any;
  if (mx <= 127 && mn >= -120) {
    enc_size(out, wsize, BT_INT8);
    for (int64_t v : a)
      out.putc((char)(int8_t)(v == I32_END ? -127 : v == I32_MISS ? -128 : v));
  } else if (mx <= 32767 && mn >= -32760) {
    enc_size(out, wsize, BT_INT16);
    for (int64_t v : a) {
      int16_t w = (int16_t)(v == I32_END ? -32767 : v == I32_MISS ? -32768 : v);
      out.put(&w, 2);
    }
  } else {
    enc_size(out, wsize, BT_INT32);
    for (int64_t v : a) { int32_t w = (int32_t)v; out.put(&w, 4); }
  }
}

struct Field { const char* p; size_t n; };

static inline bool feq(const Field& f, const char* s) {
  return strlen(s) == f.n && memcmp(f.p, s, f.n) == 0;
}

// split [p,e) on sep into out; returns count
static size_t split(const char* p, const char* e, char sep,
                    std::vector<Field>* out) {
  out->clear();
  const char* s = p;
  for (const char* q = p; q <= e; q++) {
    if (q == e || *q == sep) {
      out->push_back({s, (size_t)(q - s)});
      s = q + 1;
    }
  }
  return out->size();
}

static inline bool parse_i64(const Field& f, int64_t* v) {
  if (f.n == 0) return false;
  const char* p = f.p;
  const char* e = f.p + f.n;
  bool neg = false;
  if (*p == '-') { neg = true; p++; } else if (*p == '+') p++;
  if (p == e) return false;
  uint64_t x = 0;
  for (; p < e; p++) {
    if (*p < '0' || *p > '9') return false;
    uint64_t d = (uint64_t)(*p - '0');
    if (x > (UINT64_MAX - d) / 10) return false;  // overflow -> parse error
    x = x * 10 + d;
  }
  if (x > (uint64_t)INT64_MAX) return false;
  *v = neg ? -(int64_t)x : (int64_t)x;
  return true;
}

static inline bool parse_f32(const Field& f, uint32_t* bits) {
  char tmp[64];
  if (f.n == 0 || f.n >= sizeof(tmp)) return false;
  memcpy(tmp, f.p, f.n);
  tmp[f.n] = 0;
  char* endp = nullptr;
  float v = strtof(tmp, &endp);
  if (endp != tmp + f.n) return false;
  memcpy(bits, &v, 4);
  return true;
}

// vcf_parse_format_gt (vcf.c:3263 / record.py _parse_gt).  With v44,
// a leading '|'/'/' phases the first allele explicitly; without one it
// is inferred (haploid known -> phased; else "all others phased",
// vcf.c:3434).
static bool parse_gt(const Field& f, std::vector<int64_t>* vals, bool v44) {
  vals->clear();
  if (f.n == 0 || (f.n == 1 && f.p[0] == '.')) return true;
  bool explicit_prefix = v44 && (f.p[0] == '|' || f.p[0] == '/');
  int64_t phased = 0;
  size_t i = 0;
  while (i < f.n) {
    char c = f.p[i];
    if (c == '|') { phased = 1; i++; continue; }
    if (c == '/') { phased = 0; i++; continue; }
    if (c == '.') { vals->push_back(phased); i++; continue; }
    if (c < '0' || c > '9') return false;
    int64_t al = 0;
    while (i < f.n && f.p[i] >= '0' && f.p[i] <= '9') {
      al = al * 10 + (f.p[i] - '0');
      // allele bound (vcf.c:3480 max check): overflow -> parse error
      if (al > (INT32_MAX >> 1) - 1) return false;
      i++;
    }
    vals->push_back(((al + 1) << 1) | phased);
  }
  if (v44 && !explicit_prefix && !vals->empty()) {
    if (vals->size() == 1) {
      if ((*vals)[0] >> 1) (*vals)[0] |= 1;
    } else {
      bool anyunphased = false;
      for (size_t k = 1; k < vals->size(); k++)
        anyunphased |= !((*vals)[k] & 1);
      if (!anyunphased) (*vals)[0] |= 1;
    }
  }
  return true;
}

}  // namespace vcfp

extern "C" {

// Parse VCF body text into BCF frames.  Tables come in as string/int
// arrays; bails[] gets 1 for lines Python must re-parse.  Returns the
// output byte length via *out_ptr, or -1 OOM.  out stream layout: per
// line either a frame [u32 l_shared][u32 l_indiv][shared][indiv] (bail
// 0) or nothing (bail 1).
int64_t htstpu_vcf_parse(
    const uint8_t* text, uint64_t text_len,
    const uint8_t* id_buf, const uint64_t* id_offs, const uint32_t* id_lens,
    const int32_t* flt_def, const int32_t* info_type,
    const int32_t* fmt_type, int32_t n_id,
    const uint8_t* ctg_buf, const uint64_t* ctg_offs,
    const uint32_t* ctg_lens, int32_t n_ctg,
    int32_t gt_id, int32_t end_id, int32_t n_samples, int32_t v44,
    uint8_t* bails, int64_t max_lines, uint8_t** out_ptr) {
  using namespace vcfp;
  Tables T;
  for (int32_t i = 0; i < n_id; i++)
    T.ids.emplace(std::string((const char*)id_buf + id_offs[i], id_lens[i]),
                  i);
  for (int32_t i = 0; i < n_ctg; i++)
    T.ctgs.emplace(std::string((const char*)ctg_buf + ctg_offs[i],
                               ctg_lens[i]), i);

  Buf out;
  std::vector<Field> cols, items, parts, keys, samples, svals;
  std::vector<int64_t> ivals;
  std::vector<uint32_t> fvals;
  int64_t line_i = 0;
  const char* p = (const char*)text;
  const char* end = p + text_len;
  Buf shared, indiv;

  while (p < end && line_i < max_lines) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    const char* le = nl;
    if (le > p && le[-1] == '\r') le--;
    bool bail = false;
    shared.clear();
    indiv.clear();
    do {
      if (le == p) { bail = true; break; }    // blank: let Python skip
      split(p, le, '\t', &cols);
      if (cols.size() < 8) { bail = true; break; }
      // CHROM -> rid
      auto ci = T.ctgs.find(std::string(cols[0].p, cols[0].n));
      if (ci == T.ctgs.end()) { bail = true; break; }
      int32_t rid = ci->second;
      int64_t pos1;
      if (!parse_i64(cols[1], &pos1)) { bail = true; break; }
      int64_t pos = pos1 - 1;
      // alleles
      int64_t n_allele = 1;
      int64_t rlen = (int64_t)cols[3].n;
      // QUAL
      uint32_t qual_bits = F_MISS;
      if (!(cols[5].n == 1 && cols[5].p[0] == '.')) {
        if (!parse_f32(cols[5], &qual_bits)) { bail = true; break; }
      }
      // FILTER ids
      ivals.clear();
      if (!(cols[6].n == 1 && cols[6].p[0] == '.')) {
        split(cols[6].p, cols[6].p + cols[6].n, ';', &items);
        for (auto& it : items) {
          auto f = T.ids.find(std::string(it.p, it.n));
          if (f == T.ids.end() || flt_def[f->second] < 0) {
            bail = true;
            break;
          }
          ivals.push_back(f->second);
        }
        if (bail) break;
      }
      std::vector<int64_t> filters = ivals;

      // INFO into a scratch buffer
      Buf info_enc;
      uint32_t n_info = 0;
      int64_t end_val = INT64_MIN;
      if (!(cols[7].n == 1 && cols[7].p[0] == '.')) {
        split(cols[7].p, cols[7].p + cols[7].n, ';', &items);
        for (auto& it : items) {
          if (it.n == 0) continue;
          const char* eq = (const char*)memchr(it.p, '=', it.n);
          Field key{it.p, eq ? (size_t)(eq - it.p) : it.n};
          auto f = T.ids.find(std::string(key.p, key.n));
          if (f == T.ids.end() || info_type[f->second] < 0) {
            bail = true;
            break;
          }
          int32_t kid = f->second;
          int ht = info_type[kid];
          enc_typed_int(info_enc, kid);
          n_info++;
          if (!eq || ht == HT_FLAG) {
            enc_size(info_enc, 0, BT_NULL);
            continue;
          }
          Field val{eq + 1, (size_t)(it.p + it.n - (eq + 1))};
          split(val.p, val.p + val.n, ',', &parts);
          if (ht == HT_INT) {
            ivals.clear();
            for (auto& pv : parts) {
              int64_t v;
              if (pv.n == 1 && pv.p[0] == '.') v = I32_MISS;
              else if (!parse_i64(pv, &v)) { bail = true; break; }
              ivals.push_back(v);
            }
            if (bail) break;
            enc_vint(info_enc, ivals);
            if (kid == end_id && !ivals.empty() && ivals[0] != I32_MISS)
              end_val = ivals[0];
          } else if (ht == HT_REAL) {
            enc_size(info_enc, (int64_t)parts.size(), BT_FLOAT);
            for (auto& pv : parts) {
              uint32_t b;
              if (pv.n == 1 && pv.p[0] == '.') b = F_MISS;
              else if (!parse_f32(pv, &b)) { bail = true; break; }
              info_enc.put(&b, 4);
            }
            if (bail) break;
          } else {                      // HT_STR
            enc_size(info_enc, (int64_t)val.n, BT_CHAR);
            info_enc.put(val.p, val.n);
          }
        }
        if (bail) break;
      }
      if (end_val != INT64_MIN && end_val > pos) rlen = end_val - pos;

      // FORMAT + samples
      uint32_t n_fmt = 0;
      if (cols.size() > 8 && n_samples > 0) {
        if ((int64_t)cols.size() < 9 + n_samples) { bail = true; break; }
        split(cols[8].p, cols[8].p + cols[8].n, ':', &keys);
        // per-sample splits
        samples.assign(cols.begin() + 9, cols.begin() + 9 + n_samples);
        std::vector<std::vector<Field>> scols(n_samples);
        for (int32_t s = 0; s < n_samples; s++)
          split(samples[s].p, samples[s].p + samples[s].n, ':', &scols[s]);
        std::vector<int32_t> seen;
        for (size_t ki = 0; ki < keys.size(); ki++) {
          auto f = T.ids.find(std::string(keys[ki].p, keys[ki].n));
          if (f == T.ids.end() || fmt_type[f->second] < 0) {
            bail = true;
            break;
          }
          int32_t kid = f->second;
          bool dup = false;
          for (int32_t sk : seen) if (sk == kid) { dup = true; break; }
          if (dup) { bail = true; break; }   // Python logs the warning
          seen.push_back(kid);
          bool is_gt = kid == gt_id;
          int ht = is_gt ? HT_INT : fmt_type[kid];
          // gather per-sample raw fields (missing when index past end)
          std::vector<std::vector<int64_t>> ints;
          std::vector<std::vector<uint32_t>> flts;
          std::vector<Field> strs;
          size_t width = 1;
          if (is_gt) {
            ints.resize(n_samples);
            for (int32_t s = 0; s < n_samples; s++) {
              if (ki < scols[s].size()) {
                if (!parse_gt(scols[s][ki], &ints[s], v44 != 0)) { bail = true; break; }
              }
              if (ints[s].size() > width) width = ints[s].size();
            }
            if (bail) break;
            enc_typed_int(indiv, kid);
            n_fmt++;
            // GT ints padded with VECTOR_END; empty -> [0]
            std::vector<int64_t> flat;
            flat.reserve(n_samples * width);
            for (int32_t s = 0; s < n_samples; s++) {
              auto& v = ints[s];
              for (size_t j = 0; j < width; j++)
                flat.push_back(j < v.size() ? v[j]
                               : (j == 0 && v.empty()) ? 0 : I32_END);
            }
            enc_vint(indiv, flat, (int64_t)width);
          } else if (ht == HT_INT) {
            ints.resize(n_samples);
            std::vector<bool> missing(n_samples, false);
            for (int32_t s = 0; s < n_samples; s++) {
              if (ki >= scols[s].size()) { missing[s] = true; continue; }
              split(scols[s][ki].p, scols[s][ki].p + scols[s][ki].n, ',',
                    &parts);
              for (auto& pv : parts) {
                int64_t v;
                if (pv.n == 0 || (pv.n == 1 && pv.p[0] == '.')) v = I32_MISS;
                else if (!parse_i64(pv, &v)) { bail = true; break; }
                ints[s].push_back(v);
              }
              if (bail) break;
              if (ints[s].size() > width) width = ints[s].size();
            }
            if (bail) break;
            enc_typed_int(indiv, kid);
            n_fmt++;
            std::vector<int64_t> flat;
            flat.reserve(n_samples * width);
            for (int32_t s = 0; s < n_samples; s++) {
              if (missing[s]) {
                flat.push_back(I32_MISS);
                for (size_t j = 1; j < width; j++) flat.push_back(I32_END);
              } else {
                auto& v = ints[s];
                for (size_t j = 0; j < width; j++)
                  flat.push_back(j < v.size() ? v[j] : I32_END);
              }
            }
            enc_vint(indiv, flat, (int64_t)width);
          } else if (ht == HT_REAL) {
            flts.resize(n_samples);
            std::vector<bool> missing(n_samples, false);
            for (int32_t s = 0; s < n_samples; s++) {
              if (ki >= scols[s].size()) { missing[s] = true; continue; }
              split(scols[s][ki].p, scols[s][ki].p + scols[s][ki].n, ',',
                    &parts);
              for (auto& pv : parts) {
                uint32_t b;
                if (pv.n == 0 || (pv.n == 1 && pv.p[0] == '.')) b = F_MISS;
                else if (!parse_f32(pv, &b)) { bail = true; break; }
                flts[s].push_back(b);
              }
              if (bail) break;
              if (flts[s].size() > width) width = flts[s].size();
            }
            if (bail) break;
            enc_typed_int(indiv, kid);
            n_fmt++;
            enc_size(indiv, (int64_t)width, BT_FLOAT);
            for (int32_t s = 0; s < n_samples; s++) {
              if (missing[s]) {
                uint32_t b = F_MISS;
                indiv.put(&b, 4);
                b = F_END;
                for (size_t j = 1; j < width; j++) indiv.put(&b, 4);
              } else {
                auto& v = flts[s];
                for (size_t j = 0; j < width; j++) {
                  uint32_t b = j < v.size() ? v[j] : F_END;
                  indiv.put(&b, 4);
                }
              }
            }
          } else {                       // HT_STR
            strs.assign(n_samples, Field{nullptr, 0});
            width = 1;
            for (int32_t s = 0; s < n_samples; s++) {
              if (ki < scols[s].size()) strs[s] = scols[s][ki];
              size_t ln = strs[s].p ? strs[s].n : 1;   // "." for missing
              if (ln > width) width = ln;
            }
            enc_typed_int(indiv, kid);
            n_fmt++;
            enc_size(indiv, (int64_t)width, BT_CHAR);
            for (int32_t s = 0; s < n_samples; s++) {
              // a missing/'.' sample stores the literal '.' byte like
              // the reference text parse (vcf.c:3541); bcf_str_missing
              // 0x07 is written only by the update API, and the
              // reference prints 0x07 back as an EMPTY value
              size_t ln = 0;
              if (!strs[s].p || strs[s].n == 0) {
                indiv.putc('.');
                ln = 1;
              } else {
                indiv.put(strs[s].p, strs[s].n);
                ln = strs[s].n;
              }
              for (size_t j = ln; j < width; j++) indiv.putc((char)0);
            }
          }
        }
        if (bail) break;
      }

      // assemble shared
      int32_t v;
      v = rid; shared.put(&v, 4);
      v = (int32_t)pos; shared.put(&v, 4);
      v = (int32_t)rlen; shared.put(&v, 4);
      shared.put(&qual_bits, 4);
      split(cols[4].p, cols[4].p + cols[4].n, ',', &parts);
      bool alt_dot = cols[4].n == 0 || (cols[4].n == 1 && cols[4].p[0] == '.');
      n_allele = 1 + (alt_dot ? 0 : (int64_t)parts.size());
      uint32_t u = (uint32_t)((n_allele << 16) | n_info);
      shared.put(&u, 4);
      u = (uint32_t)((((uint32_t)n_fmt) << 24) | (uint32_t)n_samples);
      shared.put(&u, 4);
      // ID
      if (cols[2].n == 1 && cols[2].p[0] == '.') {
        enc_size(shared, 0, BT_CHAR);
      } else {
        enc_size(shared, (int64_t)cols[2].n, BT_CHAR);
        shared.put(cols[2].p, cols[2].n);
      }
      // REF + ALTs
      enc_size(shared, (int64_t)cols[3].n, BT_CHAR);
      shared.put(cols[3].p, cols[3].n);
      if (!alt_dot) {
        for (auto& a : parts) {
          enc_size(shared, (int64_t)a.n, BT_CHAR);
          shared.put(a.p, a.n);
        }
      }
      enc_vint(shared, filters);
      shared.put(info_enc.data(), info_enc.len());
    } while (0);

    bails[line_i] = bail ? 1 : 0;
    if (!bail) {
      uint32_t ls = (uint32_t)shared.len(), li = (uint32_t)indiv.len();
      out.put(&ls, 4);
      out.put(&li, 4);
      out.put(shared.data(), shared.len());
      out.put(indiv.data(), indiv.len());
    }
    line_i++;
    p = nl < end ? nl + 1 : end;
  }
  // remaining unparsed lines (max_lines undercount) -> bail
  for (; line_i < max_lines; line_i++) bails[line_i] = 1;

  uint8_t* res = (uint8_t*)malloc(out.len() ? out.len() : 1);
  if (!res) return -1;
  memcpy(res, out.data(), out.len());
  *out_ptr = res;
  return (int64_t)out.len();
}

}  // extern "C"
