// Deterministic row scatter-add: out[n, idx[n, e], :] += contrib[n, e, :],
// skipping idx < 0.
//
// Replaces: pytorch3d_pointops_tpu/kernels/scatter_pallas.py
// scatter_add_rows_pallas (kernel body _scatter_rows_kernel) and
// pytorch3d_pointops_tpu/kernels/chamfer_pallas.py scatter_add_k1_pallas
// (kernel body _scatter_k1_kernel). Both compute this same function.
//
// Design. Float atomicAdd would be fast but sums in an order that changes
// from run to run. The TPU kernel streams the entries in a fixed order into
// an accumulator of every row held in its 100 MB of VMEM. A Hopper block has
// at most 227 KB of shared memory, so the accumulator is cut by row range:
// the entries are partitioned, stably, into buckets of 2^shift consecutive
// rows, and one block a bucket streams the bucket's entries in entry order
// into an accumulator of its rows in shared memory. Every row is summed in
// ascending entry order with __fadd_rn, so the result is bit-equal to a
// sequential index_add_ (the plain twin on the CPU) and from run to run. No
// atomics touch a float. Every step runs here, on the caller's stream, with
// no host sync:
//
// 1. Flat 32-bit keys. Entry e = n * E + j gets the key n * P2 + idx[n, j];
//    a skipped entry (idx < 0, or past P2) gets N * P2, one row past every
//    row, and is never summed.
// 2. The partition (none where every row fits one bucket and the entries
//    are few): a stable LSD radix sort over the key bits from `shift` up,
//    in digits of at most 11 bits, after one zeroing of its counters:
//    histogram  one launch writes the keys and counts the digits of every
//               pass at once (shared memory integer atomics, then global
//               ones: exact in any order), since every pass sorts the same
//               multiset of keys;
//    a pass     one launch. A block takes the next tile of kTile entries
//               (a counter, so tiles start in order), counts its digits per
//               warp and publishes the counts at once. It ranks each entry
//               among the tile's entries of its digit in entry order:
//               per-warp counts scanned across warps, then each warp walks
//               its entries in order, an entry's rank being its warp's
//               running count of the digit plus the lower lanes holding the
//               same digit (one ballot per digit bit), and stages the tile
//               in shared memory in digit order. Its offset for a digit is
//               the digit's global start plus its count in earlier tiles:
//               the sum over the earlier groups of kGroup tiles, found by a
//               look-back that stops at the first group whose prefix a
//               later tile has published, plus the counts of the earlier
//               tiles of its own group. A thread takes digits kThreads
//               apart for every global word, so a warp's words are
//               consecutive. The tile then leaves in runs of consecutive
//               slots.
//    Stable passes leave each bucket's entries in ascending entry order.
// 3. The bucket sum, one launch: a block per (bucket, group of at most
//    kRegChannels channels). The block finds its bucket's entries (the
//    exclusive scan of the one pass's digit counts; a search of the sorted
//    keys after several passes; all entries, keyed from idx, without a
//    partition) and takes them in chunks of kChunk, in entry order. A chunk
//    is ranked by row in entry order as a pass ranks by digit (per-warp
//    counts scanned over warps and rows, one ballot per bit of the row) and
//    staged in shared memory in row order, each entry's values as one or
//    two vector stores. Then one thread a row adds the row's run to the
//    row's accumulator, in order, loading a batch of the run's values while
//    it adds the batch before. Loads run a step ahead: the next chunk's
//    keys once this chunk's are read, this chunk's contrib values while it
//    is ranked. After the last chunk the block writes its rows once, rows
//    with no entry included: no zero-fill. A long row costs its serial adds
//    out of shared memory, a few cycles each, not a chain of loads.
//
// Routing (kernels/scatter.py scatter_plan; measured by
// python -m pytorch3d_pointops_tpu_torch.tune_scatter): where N * P2 is at
// most kMaxBucketRows rows and N * E at most 8,192 entries (4,096 past
// 1,792 rows, where a thread scans 8 rows and a chunk costs twice as
// much), the bucket kernel alone, one launch; else buckets of 2^shift rows,
// shift = bits(N * P2) - 8 clamped to [0, 10], so one pass of 8-bit digits
// (256 buckets) up to 2^18 rows and of up to 11 bits to 2^21: a memset and
// three launches at every main-path shape. Past 2^21 rows the partition
// takes two passes; no shape falls back to another chain.
//
// Bound on the card: bytes. Each entry is read once (an 8-byte index and C
// floats) and each target row written once, one add per entry and channel.
// The partition adds its keys written and read, and its (key, entry id)
// pairs written and read once; the bucket sum reads contrib in bucket
// order, one 32-byte sector per entry and channel group, from wherever it
// lies in the cache. The serial adds of one row are the only chain: a row
// of L entries costs L dependent adds in one thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 256;                 // threads of every block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // entries a lane holds in a pass
constexpr int kWarpTile = 32 * kItems;        // entries a warp ranks
constexpr int kTile = kWarps * kWarpTile;     // entries a sort block takes
constexpr int kMaxWidth = 11;
constexpr int kRegChannels = 8;  // channels a bucket block sums at once
constexpr int kMaxBucketBits = 11;
constexpr int kMaxBucketRows = 1 << kMaxBucketBits;
constexpr int kSumItems = 8;                  // entries a lane holds in a chunk
constexpr int kChunk = kThreads * kSumItems;  // entries a bucket block takes
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoEntry = 0xffffffffu;  // key of a lane past the end

// Exclusive prefix sum of x over the block; *total gets the block's sum.
// smem holds kWarps + 1 ints. Every thread of the block must call it.
__device__ int block_exclusive_sum(int x, int* total, int* smem) {
  constexpr int W = kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < W ? smem[lane] : 0;
    int vi = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, vi, o);
      if (lane >= o) vi += y;
    }
    if (lane < W) smem[lane] = vi - v;
    if (lane == W - 1) smem[W] = vi;
  }
  __syncthreads();
  const int out = inc - x + smem[warp];
  *total = smem[W];
  __syncthreads();  // the caller may reuse smem at once
  return out;
}

// The kItems entries lane `lane` holds: base + i * 32 + lane, their keys
// and values. The first pass (FIRST) sorts the keys still in entry order,
// whose values are their entry ids; later passes read the previous pass's
// (key, value) pairs.
template <bool FIRST>
__device__ __forceinline__ void load_entries(
    const unsigned* __restrict__ keys, const uint2* __restrict__ pairs,
    unsigned M, unsigned base, unsigned (&key)[kItems], int (&val)[kItems]) {
  const unsigned lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned e = base + i * 32 + lane;
    if (FIRST) {
      key[i] = e < M ? keys[e] : kNoEntry;
      val[i] = (int)e;
    } else {
      const uint2 kv = e < M ? pairs[e] : make_uint2(kNoEntry, 0);
      key[i] = kv.x;
      val[i] = (int)kv.y;
    }
  }
}

// A lane past the end gets digit R, which no entry has.
__device__ __forceinline__ unsigned digit_of(unsigned key, int shift,
                                             unsigned R) {
  return key == kNoEntry ? R : (key >> shift) & (R - 1);
}

// The lanes of the warp whose digit equals this lane's: one ballot per bit
// of digits below 2^BITS.
template <int BITS>
__device__ __forceinline__ unsigned same_digit_lanes(unsigned d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned vote = __ballot_sync(kFull, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? vote : ~vote;
  }
  return peers;
}

// Step 1 and the global digit counts of every pass at once: the flat keys
// of a tile of entries are formed from idx and written out, and counted
// for every pass (the multiset of keys is the same in every pass). Pass p
// sorts by the digit at bit shift0 + p * width. ghist (passes x R) is
// zeroed before the launch.
__global__ void __launch_bounds__(kThreads) radix_histogram(
    const int64_t* __restrict__ idx, unsigned M, unsigned E, unsigned P2,
    unsigned skip, int shift0, int passes, int width,
    unsigned* __restrict__ keys, int* __restrict__ ghist) {
  extern __shared__ int count[];  // passes x R
  const unsigned R = 1u << width;
  const unsigned lane = threadIdx.x & 31;
  for (unsigned d = threadIdx.x; d < passes * R; d += kThreads) count[d] = 0;
  __syncthreads();
  const unsigned base = blockIdx.x * kTile + (threadIdx.x >> 5) * kWarpTile;
  int64_t q[kItems];  // every load in flight before the first is used
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned e = base + i * 32 + lane;
    q[i] = e < M ? idx[e] : -1;
  }
  // Entry e lies in cloud n = e / E at column r; one division, then steps.
  unsigned n = (base + lane) / E;
  unsigned r = base + lane - n * E;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned e = base + i * 32 + lane;
    if (i > 0) {
      for (r += 32; r >= E; r -= E) ++n;
    }
    if (e < M) {
      const unsigned key =
          (q[i] >= 0 && q[i] < (int64_t)P2) ? n * P2 + (unsigned)q[i] : skip;
      keys[e] = key;
      for (int p = 0; p < passes; ++p) {
        atomicAdd(&count[p * R + ((key >> (shift0 + p * width)) & (R - 1))],
                  1);
      }
    }
  }
  __syncthreads();
  for (unsigned d = threadIdx.x; d < passes * R; d += kThreads) {
    if (count[d] != 0) atomicAdd(&ghist[d], count[d]);
  }
}

// A tile's offset for digit d is the digit's count over all tiles before
// it. Tiles form groups of kGroup; every tile adds its counts to its
// group's sums (atomics: exact in any order) and publishes them alone, as a
// 32-bit word (pass + 1) << 24 | count. A tile reads the words of the tiles
// before it in its group, and sums the groups before its own from the
// nearest one back: the sums of complete groups until it meets a group
// whose prefix (the sum over it and every group before it) is published,
// which it adds and stops. It then publishes the prefix of the group
// before its own, so later tiles stop there. Nothing waits on a chain of
// tiles. Count words of an earlier pass read as "not yet", so one zeroing
// per sort serves every pass; each pass has its own group sums and
// prefixes.
constexpr int kGroup = 16;
constexpr unsigned kCountMask = (1u << 24) - 1;
constexpr unsigned kPublished = 1u << 31;  // a prefix word's flag
constexpr unsigned kMaxStalls = 1u << 22;  // give up rather than hang

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// Waits (bounded) until all kGroup tiles of group g have added their sums.
__device__ __forceinline__ void wait_group(const int* arrived, int g) {
  for (unsigned stalls = 0;
       load_volatile(reinterpret_cast<const unsigned*>(arrived) + g) < kGroup &&
       stalls < kMaxStalls;
       ++stalls) {
    __nanosleep(64);
  }
  __threadfence();  // the group's sums are read after its count
}

// Shared memory of radix_onesweep for digits of `width` bits.
size_t onesweep_smem(int width) {
  const size_t R = (size_t)1 << width;
  return (kWarps * R + 2 * R + 2 * kTile) * sizeof(int);
}

// One pass over the digit at bit `shift`: rank every entry of a tile among
// the tile's entries of its digit, find the tile's offset for each digit
// from the counts earlier tiles published, and write the tile out in digit
// order. Tiles are taken in the order blocks start (a counter), so a tile
// only waits on tiles already running, and those publish before they wait
// on anything.
template <bool FIRST, int WIDTH>
__global__ void __launch_bounds__(kThreads) radix_onesweep(
    const unsigned* __restrict__ first_keys, const uint2* __restrict__ pairs_in,
    unsigned M, int pass, int shift, const int* __restrict__ ghist,
    int* __restrict__ tile_counter, int* __restrict__ arrived,
    int* __restrict__ group_sum, unsigned* __restrict__ group_prefix,
    unsigned* __restrict__ tile_count, uint2* __restrict__ pairs_out) {
  extern __shared__ int smem[];
  __shared__ int scan_smem[kWarps + 1];
  __shared__ int tile_id;
  constexpr unsigned R = 1u << WIDTH;
  const unsigned flag = (unsigned)(pass + 1) << 24;
  int* wcount = smem;                     // kWarps x R: counts, then slots
  int* tile_start = wcount + kWarps * R;  // R: first tile slot of each digit
  int* out_base = tile_start + R;         // R: output slot of tile slot 0
  unsigned* stage_keys = reinterpret_cast<unsigned*>(out_base + R);  // kTile
  int* stage_vals = reinterpret_cast<int*>(stage_keys + kTile);      // kTile
  const unsigned lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* wc = wcount + warp * R;

  if (threadIdx.x == 0) tile_id = atomicAdd(tile_counter, 1);
  for (unsigned d = lane; d < R; d += 32) wc[d] = 0;
  __syncthreads();
  const int tile = tile_id;
  unsigned key[kItems];
  int val[kItems];
  load_entries<FIRST>(first_keys, pairs_in, M,
                      tile * kTile + warp * kWarpTile, key, val);
  unsigned peers[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    peers[i] = same_digit_lanes<WIDTH + 1>(digit_of(key[i], shift, R));
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = digit_of(key[i], shift, R);
    if (d < R && lane == (unsigned)(__ffs(peers[i]) - 1)) {
      atomicAdd(&wc[d], __popc(peers[i]));
    }
  }
  __syncthreads();

  // Digits d = threadIdx.x + k * kThreads, so that a warp's global words
  // are consecutive: over warps, the exclusive count within the digit; the
  // tile's count, published at once.
  for (unsigned d = threadIdx.x; d < R; d += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w * R + d];
      wcount[w * R + d] = run;
      run += c;
    }
    *reinterpret_cast<volatile unsigned*>(tile_count + (size_t)tile * R + d) =
        flag | run;
    if (run != 0) atomicAdd(&group_sum[(size_t)(tile / kGroup) * R + d], run);
    tile_start[d] = run;  // the tile's count of d, for now
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(&arrived[tile / kGroup], 1);
  // The scans in digit order: each thread takes a run of consecutive
  // digits. out_base holds each digit's global start, for now.
  constexpr unsigned per = (R + kThreads - 1) / kThreads;
  const unsigned d0 = threadIdx.x * per;
  int mine = 0, gmine = 0;
  for (unsigned d = d0; d < d0 + per && d < R; ++d) {
    mine += tile_start[d];
    gmine += ghist[d];
  }
  int tile_total, entries;
  int start = block_exclusive_sum(mine, &tile_total, scan_smem);
  int gstart = block_exclusive_sum(gmine, &entries, scan_smem);
  for (unsigned d = d0; d < d0 + per && d < R; ++d) {
    const int c = tile_start[d];
    tile_start[d] = start;
    out_base[d] = gstart;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcount[w * R + d] += start;
    start += c;
    gstart += ghist[d];
  }
  __syncthreads();

  // Rank in entry order and stage the tile in digit order.
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = digit_of(key[i], shift, R);
    const int slot = d < R ? wc[d] + __popc(peers[i] & lower) : 0;
    __syncwarp();
    if (d < R && lane == (unsigned)(__ffs(peers[i]) - 1)) {
      wc[d] += __popc(peers[i]);
    }
    __syncwarp();
    if (d < R) {
      stage_keys[slot] = key[i];
      stage_vals[slot] = val[i];
    }
  }

  // The offsets, only now: earlier tiles have had the ranking's time to
  // publish.
  const int group = tile / kGroup;
  for (unsigned d = threadIdx.x; d < R; d += kThreads) {
    unsigned before = 0;
    for (int g = group - 1; g >= 0; --g) {
      const unsigned p = load_volatile(group_prefix + (size_t)g * R + d);
      if (p & kPublished) {
        before += p & ~kPublished;
        break;
      }
      wait_group(arrived, g);
      before += __ldcg(group_sum + (size_t)g * R + d);
    }
    if (group > 0) {
      *reinterpret_cast<volatile unsigned*>(group_prefix +
                                            (size_t)(group - 1) * R + d) =
          kPublished | before;
    }
    unsigned w[kGroup - 1];
#pragma unroll
    for (int j = 0; j < kGroup - 1; ++j) {
      const int t = group * kGroup + j;
      w[j] = t < tile ? load_volatile(tile_count + (size_t)t * R + d) : flag;
    }
#pragma unroll
    for (int j = 0; j < kGroup - 1; ++j) {
      const unsigned* word = tile_count + (size_t)(group * kGroup + j) * R + d;
      for (unsigned stalls = 0;
           (w[j] & ~kCountMask) != flag && stalls < kMaxStalls; ++stalls) {
        __nanosleep(64);
        w[j] = load_volatile(word);
      }
      before += w[j] & kCountMask;
    }
    out_base[d] += (int)before - tile_start[d];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < tile_total; j += kThreads) {
    const unsigned k = stage_keys[j];
    const int o = out_base[(k >> shift) & (R - 1)] + j;
    pairs_out[o] = make_uint2(k, (unsigned)stage_vals[j]);
  }
}

// First position in sorted[0, M) whose key is >= q, found by the whole warp
// (every lane passes the same q): each step probes 32 evenly spaced keys at
// once and keeps the gap the answer lies in. The keys need only be sorted
// by key >> s where q is a multiple of 2^s.
__device__ unsigned warp_lower_bound(const uint2* sorted, unsigned M,
                                     unsigned q) {
  const unsigned lane = threadIdx.x & 31;
  unsigned lo = 0, hi = M;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const unsigned step = (hi - lo + 31) / 32;
    const unsigned p = lo + lane * step;
    const unsigned below =
        __popc(__ballot_sync(kFull, p < hi && sorted[p].x < q));
    const unsigned next_hi = min(hi, lo + below * step);
    lo = below == 0 ? lo : lo + (below - 1) * step + 1;
    hi = next_hi;
  }
  const unsigned p = lo + lane;
  return lo + __popc(__ballot_sync(kFull, p < hi && sorted[p].x < q));
}

// Floats a staged entry takes: CG rounded up to 1, 2, 4 or 8, so that its
// values move as one or two vector loads and stores.
__host__ __device__ constexpr int stage_stride(int cg) {
  return cg <= 1 ? 1 : cg <= 2 ? 2 : cg <= 4 ? 4 : 8;
}

// Shared memory of bucket_sum_kernel for buckets of rb rows and cg
// channels: the chunk's staged values (first, for their alignment), the
// accumulator, the per-warp row counts and the chunk's row starts.
size_t bucket_smem(int rb, int cg) {
  return ((size_t)kChunk * stage_stride(cg) + (size_t)rb * cg +
          (size_t)kWarps * rb + rb + 1) * sizeof(float);
}

// S = stage_stride(CG) floats at p, 4 * S bytes aligned, in and out of
// shared memory.
template <int S>
__device__ __forceinline__ void load_staged(const float* p, float (&v)[S]) {
  if constexpr (S == 1) {
    v[0] = p[0];
  } else if constexpr (S == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

// CG values into stage_stride(CG) floats at p, the rest zero.
template <int CG>
__device__ __forceinline__ void store_staged(float* p, const float (&v)[CG]) {
  constexpr int S = stage_stride(CG);
  float w[S];
#pragma unroll
  for (int c = 0; c < S; ++c) w[c] = c < CG ? v[c < CG ? c : 0] : 0.f;
  if constexpr (S == 1) {
    p[0] = w[0];
  } else if constexpr (S == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(w[0], w[1]);
  } else {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
  }
}

// Step 3: block (b, g) sums rows [b << shift, (b + 1) << shift) of the
// rows, channels [g * CG, g * CG + CG) of the C. DIRECT: one bucket holds
// every row, and the entries are read from idx in entry order; else they
// are the partition's pairs, found from its digit counts (passes == 1) or
// by a search of its sorted keys.
template <bool DIRECT, int CG>
__global__ void __launch_bounds__(kThreads, 2) bucket_sum_kernel(
    const int64_t* __restrict__ idx, const uint2* __restrict__ pairs,
    const int* __restrict__ ghist, int passes, const float* __restrict__ contrib,
    unsigned M, unsigned E, unsigned P2, unsigned rows, int shift, int C,
    float* __restrict__ out) {
  constexpr int S = stage_stride(CG);
  constexpr int kBatch = 32 / S;  // entries of a row loaded at once
  extern __shared__ __align__(16) int smem[];
  __shared__ int scan_smem[kWarps + 1];
  __shared__ unsigned range[2];
  const unsigned lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned base = blockIdx.x << shift;  // the bucket's first row
  const int rb = (int)min(1u << shift, rows - base);
  const int c0 = blockIdx.y * CG;
  const int cn = min(CG, C - c0);
  float* stage = reinterpret_cast<float*>(smem);          // kChunk x S
  float* acc = stage + kChunk * S;                        // rb x CG
  int* wcount = reinterpret_cast<int*>(acc + rb * CG);    // kWarps x rb
  int* row_start = wcount + kWarps * rb;                  // rb + 1
  int* wc = wcount + warp * rb;

  unsigned begin = 0, end = M;
  if (!DIRECT) {
    if (passes == 1) {  // the bucket is digit blockIdx.x of the one pass
      int x = 0;  // every load in flight at once
#pragma unroll
      for (int k = 0; k < (1 << kMaxWidth) / kThreads; ++k) {
        const unsigned d = threadIdx.x + k * kThreads;
        if (d < blockIdx.x) x += ghist[d];
      }
      int before;
      block_exclusive_sum(x, &before, scan_smem);
      begin = before;
      end = before + ghist[blockIdx.x];
    } else {
      if (warp < 2) {
        const unsigned at =
            warp_lower_bound(pairs, M, base + (warp ? 1u << shift : 0u));
        if (lane == 0) range[warp] = at;
      }
      __syncthreads();
      begin = range[0];
      end = range[1];
    }
  }
  for (int i = threadIdx.x; i < rb * CG; i += kThreads) acc[i] = 0.f;

  // A chunk's entries: lane `lane` of warp w holds entries cb + w * 32 *
  // kSumItems + i * 32 + lane, so (w, i, lane) is entry order. Loads run a
  // step ahead: the next chunk's indices or pairs once this chunk's are
  // read, this chunk's contrib values while it is ranked.
  using Raw = std::conditional_t<DIRECT, int64_t, uint2>;
  Raw raw[kSumItems];
  auto load_raw = [&](unsigned cb) {
    const unsigned wbase = cb + warp * (32 * kSumItems);
#pragma unroll
    for (int i = 0; i < kSumItems; ++i) {
      const unsigned e = wbase + i * 32 + lane;
      if constexpr (DIRECT) {
        raw[i] = e < end ? idx[e] : -1;
      } else {
        raw[i] = e < end ? pairs[e] : make_uint2(kNoEntry, 0);
      }
    }
  };
  if (begin < end) load_raw(begin);

  const unsigned lower = (1u << lane) - 1;
  for (unsigned cb = begin; cb < end; cb += kChunk) {
    const unsigned wbase = cb + warp * (32 * kSumItems);
    // Row d of the bucket; rb for a skipped entry or a lane past the end.
    int d[kSumItems];
    float x[kSumItems][CG];
#pragma unroll
    for (int i = 0; i < kSumItems; ++i) {
      const unsigned e = wbase + i * 32 + lane;
      unsigned key, val;
      bool load;
      if constexpr (DIRECT) {
        key = raw[i] >= 0 && raw[i] < (int64_t)P2
                  ? (e / E) * P2 + (unsigned)raw[i] : kNoEntry;
        val = e;
        load = e < end;  // the loads need not wait for idx
      } else {
        key = raw[i].x;
        val = raw[i].y;
        load = key < rows;
      }
      d[i] = key < rows ? (int)(key - base) : rb;
      const float* v = contrib + (size_t)val * C + c0;
#pragma unroll
      for (int c = 0; c < CG; ++c) x[i][c] = load && c < cn ? v[c] : 0.f;
    }
    if (cb + kChunk < end) load_raw(cb + kChunk);
    for (int r = lane; r < rb; r += 32) wc[r] = 0;
    unsigned peers[kSumItems];
#pragma unroll
    for (int i = 0; i < kSumItems; ++i) {
      peers[i] = same_digit_lanes<kMaxBucketBits + 1>(d[i]);
    }
    __syncwarp();  // this warp's counts are zero
#pragma unroll
    for (int i = 0; i < kSumItems; ++i) {
      if (d[i] < rb && lane == (unsigned)(__ffs(peers[i]) - 1)) {
        atomicAdd(&wc[d[i]], __popc(peers[i]));
      }
    }
    __syncthreads();

    // Each thread takes a run of consecutive rows: over warps, the
    // exclusive count within the row; then the rows' starts in the chunk.
    const int per = (rb + kThreads - 1) / kThreads;
    const int r0 = threadIdx.x * per;
    const int r1 = min(r0 + per, rb);
    int mine = 0;
    for (int r = r0; r < r1; ++r) {
      int c[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c[w] = wcount[w * rb + r];
      int run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        wcount[w * rb + r] = run;
        run += c[w];
      }
      row_start[r] = run;  // the row's count, for now
      mine += run;
    }
    int total;
    int start = block_exclusive_sum(mine, &total, scan_smem);
    for (int r = r0; r < r1; ++r) {
      const int c = row_start[r];
      row_start[r] = start;
      start += c;
    }
    if (threadIdx.x == 0) row_start[rb] = total;
    __syncthreads();

    // Rank in entry order and stage the chunk in row order.
#pragma unroll
    for (int i = 0; i < kSumItems; ++i) {
      const int slot =
          d[i] < rb ? row_start[d[i]] + wc[d[i]] + __popc(peers[i] & lower) : 0;
      __syncwarp();
      if (d[i] < rb && lane == (unsigned)(__ffs(peers[i]) - 1)) {
        wc[d[i]] += __popc(peers[i]);
      }
      __syncwarp();
      if (d[i] < rb) store_staged<CG>(stage + slot * S, x[i]);
    }
    __syncthreads();

    // One thread a row adds the row's run in entry order, kBatch entries'
    // values loaded while the kBatch before them are added.
    for (int r = threadIdx.x; r < rb; r += kThreads) {
      const int a = row_start[r], b = row_start[r + 1];
      if (a == b) continue;
      float s[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) s[c] = acc[r * CG + c];
      auto add = [&](const float (&v)[kBatch][S]) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
#pragma unroll
          for (int c = 0; c < CG; ++c) s[c] = __fadd_rn(s[c], v[u][c]);
        }
      };
      auto load = [&](float (&v)[kBatch][S], int j) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) load_staged<S>(stage + (j + u) * S, v[u]);
      };
      int j = a;
      if (b - j >= kBatch) {
        float va[kBatch][S], vb[kBatch][S];
        load(va, j);
        j += kBatch;
        while (true) {
          if (b - j < kBatch) {
            add(va);
            break;
          }
          load(vb, j);
          j += kBatch;
          add(va);
          if (b - j < kBatch) {
            add(vb);
            break;
          }
          load(va, j);
          j += kBatch;
          add(vb);
        }
      }
      for (; j < b; ++j) {
        float v[S];
        load_staged<S>(stage + j * S, v);
#pragma unroll
        for (int c = 0; c < CG; ++c) s[c] = __fadd_rn(s[c], v[c]);
      }
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[r * CG + c] = s[c];
    }
    __syncthreads();
  }
  __syncthreads();  // an empty bucket zeroed its accumulator
  for (int i = threadIdx.x; i < rb * cn; i += kThreads) {
    const int r = i / cn, c = i - r * cn;
    out[(size_t)(base + r) * C + c0 + c] = acc[r * CG + c];
  }
}

int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

// The work buffer, in ints: (key, entry id) pairs (two halves of M pairs),
// the keys in entry order, then the part zeroed before each sort: the
// global digit counts (passes x R), per pass a tile counter, per pass and
// group an arrival counter, its digit sums and its prefix words, and the
// tiles' count words (tiles x R).
struct Work {
  int64_t pairs, keys, ghist, counters, arrived, group_sum, group_prefix,
      tile_count, end;
};

Work work_layout(int64_t M, int passes, int width) {
  const int64_t R = (int64_t)1 << width;
  const int64_t tiles = ceil_div(M, kTile);
  const int64_t groups = (tiles + kGroup - 1) / kGroup;
  Work w;
  w.pairs = 0;
  w.keys = 4 * M;
  w.ghist = 5 * M;
  w.counters = w.ghist + passes * R;
  w.arrived = w.counters + passes;
  w.group_sum = w.arrived + passes * groups;
  w.group_prefix = w.group_sum + passes * groups * R;
  w.tile_count = w.group_prefix + passes * groups * R;
  w.end = w.tile_count + tiles * R;
  return w;
}

// radix_onesweep for digits of `width` bits, 1..kMaxWidth.
using Sweep = void (*)(const unsigned*, const uint2*, unsigned, int, int,
                       const int*, int*, int*, int*, unsigned*, unsigned*,
                       uint2*);
using kWidths = std::make_integer_sequence<int, kMaxWidth>;

template <bool FIRST, int... W>
Sweep sweep_for(int width, std::integer_sequence<int, W...>) {
  const Sweep sweeps[] = {radix_onesweep<FIRST, W + 1>...};
  return sweeps[width - 1];
}

// bucket_sum_kernel for CG channels, 1..kRegChannels.
using BucketSum = void (*)(const int64_t*, const uint2*, const int*, int,
                           const float*, unsigned, unsigned, unsigned,
                           unsigned, int, int, float*);
using kChannelCounts = std::make_integer_sequence<int, kRegChannels>;

template <bool DIRECT, int... G>
BucketSum bucket_sum_for(int cg, std::integer_sequence<int, G...>) {
  const BucketSum sums[] = {bucket_sum_kernel<DIRECT, G + 1>...};
  return sums[cg - 1];
}

// Lets kernel `fn` take `bytes` of dynamic shared memory on the current
// device. The attribute is per device and the call costs microseconds of
// host time, so each device sets it once per kernel and size: `slot`
// names the kernel (see the *_slot functions), and the largest size set so
// far is kept.
constexpr int kMaxDevices = 64;
constexpr int kSmemSlots = 2 * kMaxWidth + 2 * kRegChannels;

int sweep_slot(bool first, int width) {
  return (first ? 0 : kMaxWidth) + width - 1;
}

int bucket_slot(bool direct, int channels) {
  return 2 * kMaxWidth + (direct ? kRegChannels : 0) + channels - 1;
}

cudaError_t allow_smem(const void* fn, int slot, size_t bytes) {
  static size_t allowed[kMaxDevices][kSmemSlots];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev][slot] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) allowed[dev][slot] = bytes;
  return cudaSuccess;
}

// Records events[(*mark)++] on the stream if events is not null.
cudaError_t record(void* const* events, int* mark, cudaStream_t stream) {
  if (events == nullptr) return cudaSuccess;
  return cudaEventRecord(static_cast<cudaEvent_t>(events[(*mark)++]), stream);
}

// Steps 1-2 into work (see Work): the partition, a stable sort by the key
// bits from shift0 on, in `passes` passes of `width`-bit digits; the
// (key, entry id) pairs are left in half (passes - 1) % 2 of the pairs.
// Records an event after each step, launched or not (no entries launch
// nothing but the zeroing).
cudaError_t partition(const int64_t* idx, int N, int E, int P2, int shift0,
                      int passes, int width, int* work, void* const* events,
                      int* mark, cudaStream_t stream) {
  const int64_t M = (int64_t)N * E;
  const int64_t buckets = (int64_t)N * P2;  // keys run 0..N*P2
  const int top = shift0 + passes * width;
  if (N < 0 || E < 0 || P2 < 0 || shift0 < 0 || passes < 1 || width < 1 ||
      width > kMaxWidth || buckets >= 0x7fffffffLL || M > 0x7fffffffLL ||
      (top < 32 && (buckets >> top) != 0)) {
    return cudaErrorInvalidValue;
  }
  const unsigned R = 1u << width;
  const int tiles = ceil_div(M, kTile);
  const Work w = work_layout(M, passes, width);
  uint2* pairs = reinterpret_cast<uint2*>(work + w.pairs);
  unsigned* keys = reinterpret_cast<unsigned*>(work + w.keys);
  int* ghist = work + w.ghist;
  int* counters = work + w.counters;
  const int64_t groups = (w.group_sum - w.arrived) / passes;
  const unsigned skip = (unsigned)N * (unsigned)P2;
  const size_t sweep_smem = onesweep_smem(width);
  const Sweep first = sweep_for<true>(width, kWidths{});
  const Sweep later = sweep_for<false>(width, kWidths{});
  cudaError_t err;
  if ((err = allow_smem((const void*)first, sweep_slot(true, width),
                        sweep_smem)) != cudaSuccess ||
      (err = allow_smem((const void*)later, sweep_slot(false, width),
                        sweep_smem)) != cudaSuccess ||
      (err = cudaMemsetAsync(ghist, 0, (w.end - w.ghist) * sizeof(int),
                             stream)) != cudaSuccess ||
      (err = record(events, mark, stream)) != cudaSuccess) {
    return err;
  }
  if (tiles > 0) {
    radix_histogram<<<tiles, kThreads, passes * R * sizeof(int), stream>>>(
        idx, (unsigned)M, E, P2, skip, shift0, passes, width, keys, ghist);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || (err = record(events, mark, stream)) != cudaSuccess) {
    return err;
  }
  for (int p = 0; p < passes; ++p) {
    if (tiles > 0) {
      (p == 0 ? first : later)<<<tiles, kThreads, sweep_smem, stream>>>(
          keys, pairs + (size_t)((p + 1) % 2) * M, (unsigned)M, p,
          shift0 + p * width, ghist + p * R, counters + p,
          work + w.arrived + p * groups, work + w.group_sum + p * groups * R,
          reinterpret_cast<unsigned*>(work + w.group_prefix + p * groups * R),
          reinterpret_cast<unsigned*>(work + w.tile_count),
          pairs + (size_t)(p % 2) * M);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess ||
        (err = record(events, mark, stream)) != cudaSuccess) {
      return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Ints of the work buffer of a partition of M entries in `passes` passes
// of `width`-bit digits (none for passes == 0: no partition).
extern "C" int64_t scatter_work_ints(int64_t M, int passes, int width) {
  return passes == 0 ? 0 : work_layout(M, passes, width).end;
}

// The whole scatter of idx (N, E) int64 and contrib (N, E, C) float32 into
// out (N, P2, C) float32, under the plan kernels/scatter.py scatter_plan
// picks: buckets of 2^shift rows, `channels` channels a block, and the
// partition in `passes` passes of `width`-bit digits from bit `shift` (no
// partition for passes == 0, where 2^shift >= N * P2 and every row is one
// bucket). work holds scatter_work_ints(N * E, passes, width) ints. If
// events is not null it holds 2 cudaEvent_t without a partition, else
// passes + 4, recorded before the first step and after each (the zeroing,
// the histogram, each pass, the bucket sum). Returns the first cudaError_t
// met.
extern "C" int scatter_add(const int64_t* idx, const float* contrib, int N,
                           int E, int P2, int C, int shift, int passes,
                           int width, int channels, int* work, float* out,
                           void* const* events, void* stream_ptr) {
  const int64_t M = (int64_t)N * E;
  const int64_t rows = (int64_t)N * P2;
  if (rows <= 0 || C <= 0) return cudaSuccess;
  if (M < 0 || M > 0x7fffffffLL || rows >= 0x7fffffffLL || shift < 0 ||
      shift > kMaxBucketBits + 1 || passes < 0 || channels < 1 ||
      channels > kRegChannels ||
      (passes == 0 && rows > ((int64_t)1 << shift))) {
    return cudaErrorInvalidValue;
  }
  const int64_t rb = rows < ((int64_t)1 << shift) ? rows : (int64_t)1 << shift;
  if (rb > kMaxBucketRows) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int mark = 0;
  cudaError_t err = record(events, &mark, stream);
  if (err != cudaSuccess) return err;
  if (passes > 0) {
    err = partition(idx, N, E, P2, shift, passes, width, work, events, &mark,
                    stream);
    if (err != cudaSuccess) return err;
  }
  const bool direct = passes == 0;
  const BucketSum sum = direct ? bucket_sum_for<true>(channels, kChannelCounts{})
                               : bucket_sum_for<false>(channels, kChannelCounts{});
  const size_t smem = bucket_smem((int)rb, channels);
  err = allow_smem((const void*)sum, bucket_slot(direct, channels), smem);
  if (err != cudaSuccess) return err;
  const uint2* sorted = nullptr;
  const int* ghist = nullptr;
  if (!direct) {
    sorted = reinterpret_cast<const uint2*>(work) + (size_t)((passes - 1) % 2) * M;
    ghist = work + work_layout(M, passes, width).ghist;
  }
  const dim3 grid((unsigned)ceil_div(rows, rb),
                  (unsigned)ceil_div(C, channels));
  sum<<<grid, kThreads, smem, stream>>>(
      idx, sorted, ghist, passes, contrib, (unsigned)M, (unsigned)E,
      (unsigned)P2, (unsigned)rows, shift, C, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return record(events, &mark, stream);
}
