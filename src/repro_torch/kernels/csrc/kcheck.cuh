// The checked build's memory and race checks, on the card.
//
// The port's run-time counterpart of the reference's Pallas grid checks
// (src/repro/analysis/pallaspass.py: CA401 write races, CA402 output
// tiles left unwritten, CA403 out-of-bounds blocks).  Every kernel source
// includes this header and marks its accesses with the macros below.
//
// Without REPRO_KCHECK (the production build) every macro expands to
// nothing, so a production library compiles to what it was without them.
// With it (`kernels.build.build(checked=True)`) each library holds one
// checker state:
//   * up to kMaxRegions registered device buffers: base, bytes, element
//     size and role (input, output or scratch), and for an output or
//     scratch buffer a uint32 write count per element;
//   * the first error, claimed with atomicCAS: its code, region, byte
//     offset, block, thread and source line; the number of errors and of
//     checked accesses;
//   * a jitter seed.
// The host arms the state before a launch (`kcheck_arm`) and reads it
// after (`kcheck_read`, which disarms it), so no kernel signature
// changes.  An error is recorded, never asserted: the launch runs to its
// end and the caller reports it.  A disarmed state checks nothing.
//
//   KC_LD(ptr, bytes)   a global load: the bytes lie inside one registered
//                       buffer, aligned to the lowest set bit of `bytes`
//                       (at most 16) (else CA403); from an output or scratch
//                       buffer every element they cover has been written
//                       (else a read of unwritten memory, CA402)
//   KC_ST(ptr, bytes)   a global store: inside an output or scratch buffer
//                       (a store into an input is CA403); adds one to the
//                       write count of every element it covers
//   KC_SH(ptr, bytes)   a shared-memory access the kernel computes itself:
//                       inside the block's shared allocation (else CA403)
//   KC_JITTER(iter)     with a nonzero seed, sleeps the warp for a hashed
//                       0-1023 ns of (seed, block, warp, source line,
//                       iter).  Placed at the top of main-loop iterations
//                       and before barriers, it shakes the schedule, so
//                       that a missing barrier changes a result
//   KC_HOST_RANGE(ptr, bytes)  host side: a range a launch will read
//                       (a TMA tensor map's extent) lies inside a
//                       registered buffer (else CA403)
//
// The checks see addresses, not provenance: an access that lands inside
// another registered buffer of an allowed role passes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef REPRO_KCHECK

namespace kcheck {

constexpr int kMaxRegions = 8;

enum Role : int { kInput = 0, kOutput = 1, kScratch = 2 };

// error codes; analysis/kernelpass.py maps each to its rule
enum Code : int {
  kNone = 0,
  kOutOfRange = 1,         // CA403: a global access outside every buffer
  kStoreToInput = 2,       // CA403: a store into an input buffer
  kSharedOutOfRange = 3,   // CA403: outside the block's shared allocation
  kMisaligned = 4,         // CA403: a global access off its natural alignment
  kUnwrittenRead = 5,      // CA402: a read of output or scratch memory
                           //        before its write
  kMapOutOfRange = 6,      // CA403: a TMA tensor map past its tensor (host)
};

struct Region {
  unsigned long long base, bytes;
  unsigned int* counts;    // one write count per element, or null (inputs)
  int elem, role;
};

struct Config {
  Region region[kMaxRegions];
  int n;                   // registered regions; 0 = disarmed
  unsigned int seed;       // jitter seed; 0 = no jitter
};

struct Record {
  int code, region, site, pad;
  long long offset, extent;
  int block[3], thread[3];
  unsigned long long errors, accesses;
};

// the fields kcheck_read returns, in order (kernelpass.RECORD_FIELDS)
constexpr int kRecordFields = 13;

static __constant__ Config c_cfg;
static __device__ Record g_rec;

static Config h_cfg;       // the host's copy of the armed regions
static Record h_rec;       // the first host-side error

__device__ __forceinline__ unsigned lane_id() {
  unsigned lane;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(lane));
  return lane;
}

// one count per warp of the checked accesses its active threads make
__device__ __forceinline__ void count_access() {
  const unsigned mask = __activemask();
  if (lane_id() == (unsigned)(__ffs(mask) - 1))
    atomicAdd(&g_rec.accesses, (unsigned long long)__popc(mask));
}

__device__ __forceinline__ void report(int code, int region, long long offset,
                                       long long extent, int site) {
  atomicAdd(&g_rec.errors, 1ull);
  if (atomicCAS(&g_rec.code, 0, code) != 0) return;
  g_rec.region = region;
  g_rec.site = site;
  g_rec.offset = offset;
  g_rec.extent = extent;
  g_rec.block[0] = blockIdx.x;
  g_rec.block[1] = blockIdx.y;
  g_rec.block[2] = blockIdx.z;
  g_rec.thread[0] = threadIdx.x;
  g_rec.thread[1] = threadIdx.y;
  g_rec.thread[2] = threadIdx.z;
}

// out of line: a kernel has up to ~100 global access sites, and one
// inlined copy each would multiply the checked build's compile time.  No
// site calls it while a wgmma is in flight (the shared checks stay
// inline).
__device__ __noinline__ void global_access(const void* p, unsigned bytes,
                                           bool store, int site) {
  const int n = c_cfg.n;
  if (n == 0 || bytes == 0) return;
  count_access();
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  int hit = -1, input = -1, near = -1;
  for (int i = 0; i < kMaxRegions && i < n; ++i) {
    const Region& r = c_cfg.region[i];
    if (a >= r.base && a + bytes <= r.base + r.bytes) {
      if (!store || r.role != kInput) {
        hit = i;
        break;
      }
      input = i;
    }
    if (a >= r.base && (near < 0 || r.base > c_cfg.region[near].base))
      near = i;
  }
  if (hit < 0) {
    const int rg = input >= 0 ? input : near;
    report(input >= 0 ? kStoreToInput : kOutOfRange, rg,
           rg >= 0 ? (long long)(a - c_cfg.region[rg].base) : (long long)a,
           rg >= 0 ? (long long)c_cfg.region[rg].bytes : 0, site);
    return;
  }
  const Region& r = c_cfg.region[hit];
  const unsigned long long off = a - r.base;
  // the alignment of the access's widest power-of-two part: a vector of
  // 16 bytes, or one element of a group of scalars checked together
  const unsigned low = bytes & (0u - bytes);
  const unsigned align = low > 16u ? 16u : low;
  if ((a & (align - 1)) != 0) {
    report(kMisaligned, hit, (long long)off, (long long)r.bytes, site);
    return;
  }
  if (r.counts == nullptr) return;
  const unsigned long long first = off / r.elem;
  const unsigned long long last = (off + bytes - 1) / r.elem;
  for (unsigned long long e = first; e <= last; ++e) {
    if (store) {
      atomicAdd(&r.counts[e], 1u);
    } else if (*reinterpret_cast<volatile unsigned*>(&r.counts[e]) == 0) {
      report(kUnwrittenRead, hit, (long long)off, (long long)r.bytes, site);
      return;
    }
  }
}

// [lo, hi): the block's shared allocation in the shared window.  On
// sm_90 the window holds the reserved bytes first (1 KB), then the static
// arrays (their size rounded up to 128 bytes), then the dynamic ones:
// %aggr_smem_size is all three, %total_smem_size the last two.
__device__ __forceinline__ void smem_window(unsigned& lo, unsigned& hi) {
  unsigned total, aggr;
  asm volatile("mov.u32 %0, %%total_smem_size;\n" : "=r"(total));
  asm volatile("mov.u32 %0, %%aggr_smem_size;\n" : "=r"(aggr));
  lo = aggr - total;
  hi = aggr;
}

__device__ __forceinline__ void shared_access(const void* p, unsigned bytes,
                                              int site) {
  if (c_cfg.n == 0) return;
  count_access();
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned lo, hi;
  smem_window(lo, hi);
  if (a < lo || a + bytes > hi)
    report(kSharedOutOfRange, -1, (long long)a - (long long)lo,
           (long long)(hi - lo), site);
}

__device__ __forceinline__ void jitter(int site, unsigned iter) {
  const unsigned seed = c_cfg.seed;
  if (c_cfg.n == 0 || seed == 0) return;
  const unsigned tid =
      threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
  const unsigned blk =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  // splitmix64 of the warp's coordinates: every thread of a warp sleeps
  // the same time, so the warp stays converged
  unsigned long long h = seed * 0x9E3779B97F4A7C15ull;
  h ^= ((unsigned long long)blk << 20) ^ (tid / 32);
  h += (unsigned long long)site * 0xBF58476D1CE4E5B9ull +
       (unsigned long long)iter * 0x94D049BB133111EBull;
  h ^= h >> 30;
  h *= 0xBF58476D1CE4E5B9ull;
  h ^= h >> 27;
  h *= 0x94D049BB133111EBull;
  h ^= h >> 31;
  __nanosleep((unsigned)(h % 1024));
  asm volatile("" ::: "memory");   // no access moves above the sleep
}

inline void host_range(const void* p, unsigned long long bytes, int site) {
  if (h_cfg.n == 0 || h_rec.code != 0) return;
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  int near = -1;
  for (int i = 0; i < h_cfg.n; ++i) {
    const Region& r = h_cfg.region[i];
    if (a >= r.base && a + bytes <= r.base + r.bytes) return;
    if (a >= r.base && (near < 0 || r.base > h_cfg.region[near].base))
      near = i;
  }
  h_rec.code = kMapOutOfRange;
  h_rec.region = near;
  h_rec.site = site;
  h_rec.offset = near >= 0 ? (long long)(a - h_cfg.region[near].base)
                           : (long long)a;
  h_rec.extent = near >= 0 ? (long long)(a + bytes - h_cfg.region[near].base)
                           : (long long)bytes;
  h_rec.errors = 1;
}

}  // namespace kcheck

// Arm the check for the next launches of this library: n regions (base,
// bytes, element size, role, write counts or null each) and the jitter
// seed.  The counts must be zeroed device buffers of bytes / elem uint32.
extern "C" int kcheck_arm(int n, const unsigned long long* base,
                          const unsigned long long* bytes, const int* elem,
                          const int* role, void* const* counts,
                          unsigned int seed) {
  using namespace kcheck;
  if (n < 1 || n > kMaxRegions) return (int)cudaErrorInvalidValue;
  Config c{};
  for (int i = 0; i < n; ++i) {
    if (elem[i] < 1 || role[i] < kInput || role[i] > kScratch)
      return (int)cudaErrorInvalidValue;
    c.region[i] = Region{base[i], bytes[i],
                         static_cast<unsigned int*>(counts[i]), elem[i],
                         role[i]};
  }
  c.n = n;
  c.seed = seed;
  const Record r{};
  h_cfg = c;
  h_rec = r;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_rec, &r, sizeof r);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_cfg, &c, sizeof c);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return (int)err;
}

// Wait for the launches, write the record's kRecordFields fields to out
// (code, region, offset, extent, site, block x y z, thread x y z, errors,
// accesses; a host-side error comes first) and disarm the check.
extern "C" int kcheck_read(long long* out) {
  using namespace kcheck;
  Record r{};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(&r, g_rec, sizeof r);
  const Config off{};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(c_cfg, &off, sizeof off);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  h_cfg = off;
  if (err != cudaSuccess) return (int)err;
  const unsigned long long errors = r.errors + h_rec.errors;
  const unsigned long long accesses = r.accesses;
  if (h_rec.code != 0) r = h_rec;
  const long long f[kRecordFields] = {
      r.code,      r.region,    r.offset,    r.extent,
      r.site,      r.block[0],  r.block[1],  r.block[2],
      r.thread[0], r.thread[1], r.thread[2], (long long)errors,
      (long long)accesses};
  for (int i = 0; i < kRecordFields; ++i) out[i] = f[i];
  return 0;
}

#define KC_LD(ptr, bytes) \
  ::kcheck::global_access((ptr), (unsigned)(bytes), false, __LINE__)
#define KC_ST(ptr, bytes) \
  ::kcheck::global_access((ptr), (unsigned)(bytes), true, __LINE__)
#define KC_SH(ptr, bytes) \
  ::kcheck::shared_access((ptr), (unsigned)(bytes), __LINE__)
#define KC_JITTER(iter) ::kcheck::jitter(__LINE__, (unsigned)(iter))
#define KC_HOST_RANGE(ptr, bytes) \
  ::kcheck::host_range((ptr), (unsigned long long)(bytes), __LINE__)

#else  // production: every check is nothing

#define KC_LD(ptr, bytes) ((void)0)
#define KC_ST(ptr, bytes) ((void)0)
#define KC_SH(ptr, bytes) ((void)0)
#define KC_JITTER(iter) ((void)0)
#define KC_HOST_RANGE(ptr, bytes) ((void)0)

#endif  // REPRO_KCHECK
