// Gradient of an embedding-table gather, routed by a host-built gather plan.
//
// Replaces the Pallas TPU kernel subgnn_tpu/ops/embedding.py:162
// (_segment_matmul_pallas: per 512-slot tile, onehot(local)^T @ g[pos] into
// the tile's 128-row table block, tiles of one block accumulated in place in
// VMEM while the grid walks them in order on one core). Same result:
//   dtable[block*128 + local] = sum over the plan's slots of g[pos]   (fp32)
// written in the cotangent's dtype, which is the table's (fp32 or bf16);
// rows no slot names are 0, and so are rows past the plan.
//
// The plan (subgnn_tpu_torch/ops/embedding.py:make_gather_plan): pos/local
// (T, W) int32, block (T,) int32 non-decreasing. The slots of one table block
// are its ids sorted (stable argsort) and cut into consecutive tiles, so over
// the flat (S = T*W) slot array the row key block*128 + local is
// non-decreasing over the real slots and every row's slots form ONE
// contiguous run. Padding slots (local == 128) come only at the end of a
// table block's last tile and in whole padding tiles, so they never split a
// run, and the slot after a padding slot starts a new table block.
//
// What bounds it on an H100: bytes. Each real slot reads its pos and one
// D-wide cotangent row, every slot its local (at B=1280 bf16 the neigh plan
// reads 345,600 x (128 x 2 + 4) B = 89.9 MB, 1.6 MB of local and ~2.1 MB
// of output: ~0.028 ms at 3.35 TB/s); the adds are one fp32 flop per
// element read (1/16 of that time at 67 TFLOP/s). No tensor-core product
// applies.
//
// Design (one launch, no memset):
//   * slot-balanced blocks: each block of 16 warps owns the contiguous slot
//     range [16*sw*b, 16*sw*(b+1)), sw slots to a warp. The caller picks sw
//     (64, 32, 16 or 8) from S alone, the most that still gives a grid of
//     264 blocks or more, so the partition depends on the plan's size, never
//     on the card.
//     Lane l holds columns [l*VEC, l*VEC+VEC) (VEC = D/32) of the running
//     row sum in fp32 registers. The warp loads its slots' local/pos at once
//     and broadcasts them with __shfl_sync; padding slots are skipped by
//     local and their pos is never read.
//   * bytes in flight come from occupancy: three blocks (48 warps) per SM,
//     each warp with 32 bytes a lane of cotangent rows in flight (4 bf16 or
//     2 fp32 rows at D=128), keep ~48 KB a SM in flight, above the ~26 KB
//     that 3.35 TB/s x ~1 us needs. Deeper per-warp unrolls cost registers,
//     and so warps or spills, and measured slower; so did 16-byte loads
//     that bring two bf16 D=128 rows a warp instruction, and loading the
//     next chunk's local/pos early gained nothing (PERF.md).
//   * a run wholly inside a warp's range is written straight to the output.
//     The pieces of runs that cross a warp edge go to shared memory and the
//     block sums them in warp order; a crossing run that starts and ends in
//     the block is written there. Only a run that crosses a BLOCK edge leaves
//     fp32 partials in scratch: at most two per block (one for the run it
//     continues, one for the run it hands on).
//   * the last block to finish such a run sums it, in the same launch: each
//     block of the run adds to the run's 64-bit ticket word (tickets[row]),
//     which counts the blocks and learns from the run's first and last
//     blocks where it begins and ends (ticket_whole); the block whose add
//     makes the word whole sums the partials of blocks b..e in an order fixed
//     by b and e, and sets the word back to 0, so the words stay zero between
//     calls (the caller allocates them zeroed once). The PAD row (a third of
//     the neigh slots) leaves ~110 partials at the bf16 neigh plan.
//   * no memset: the slot where a run begins zeroes the unnamed rows between
//     the previous real slot's row and its own (or from its table block's
//     first row, after padding); the slot where a run ends before padding
//     zeroes the rest of its table block; the first slot of a table block
//     that has no ids zeroes that block; block 0 zeroes the rows past the
//     plan's last table block. Every output row has exactly one writer.
//   * deterministic: no float atomics, and every sum runs in an order fixed
//     by the plan whichever block finishes a run, so the same plan and
//     cotangent give the same bits on every run and every card (index_add_
//     and float atomicAdd do not).
//
// Any width D. The fast set is D = 32 * VEC (VEC of 1, 2, 4 or 8) with g and
// out 16-byte aligned: lane l holds columns [l*VEC, l*VEC+VEC) and moves
// them as one vector. Every other D, and a fast-set D whose g is not so
// aligned, takes the general path (ANY): the row is cut into slabs of up to
// 256 columns, one launch a slab, one after another on the stream (so the
// slabs share the scratch and the ticket words, which each launch leaves
// zero). In a slab of nc columns lane l holds columns l, l+32, ... below nc,
// with VEC the least of 1, 2, 4, 8 that covers nc; loads and stores are
// scalar (a bf16 row of D=100 is 200 bytes, so rows are not 16-byte
// aligned), the row stride D is passed apart from the slab width, and every
// zero fill and row store is masked to the slab's columns, so every output
// element still has exactly one writer. The slot partition, the runs, the
// tickets and the order of every sum are the fast set's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTableBlock = 128;  // rows per table block (TABLE_BLOCK)
constexpr int kWarps = 16;        // warps per block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// per-warp state in shared memory
constexpr int kBusy = 1;       // the warp's range holds slots
constexpr int kOpenStart = 2;  // its first run began before its range
constexpr int kOpenEnd = 4;    // its last run goes on past its range
constexpr int kWhole = 8;      // one run covers the range, open at both ends

// what a block leaves in scratch; partial 2b holds kHead or kThrough, 2b+1
// kTail
constexpr int kHead = 1;     // a run begun in an earlier block ends here
constexpr int kThrough = 2;  // one run, begun earlier, covers the block
constexpr int kTail = 4;     // a run begun here goes on into the next block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC contiguous elements as one (or two) vector accesses: rows are D*size
// bytes with D a multiple of 32, and the base is 16-byte aligned.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T) > 16 ? 16 : VEC * sizeof(T)) Pack {
  T x[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float (&v)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.x[i] = from_float<T>(v[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// column of a slab held in element i of lane `lane`'s VEC: contiguous in
// the fast set, lane-strided in the general path
template <int VEC, bool ANY>
__device__ __forceinline__ int col(int lane, int i) {
  return ANY ? lane + 32 * i : lane * VEC + i;
}

// the lane's VEC values into a row whose column 0 is at `row`: one vector
// store in the fast set, scalar stores below nc columns in the general path
template <typename T, int VEC, bool ANY>
__device__ __forceinline__ void put_row(T* row, const float (&v)[VEC],
                                        int lane, int nc) {
  if constexpr (ANY) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = col<VEC, ANY>(lane, i);
      if (c < nc) row[c] = from_float<T>(v[i]);
    }
  } else {
    store_row<T, VEC>(row + lane * VEC, v);
  }
}

// adds VEC contiguous fp32 partial values, read from L2 (other blocks wrote
// them), as the fast set's vector loads
template <int VEC>
__device__ __forceinline__ void add_partial_vec(const float* p,
                                                float (&acc)[VEC]) {
  if constexpr (VEC == 1) {
    acc[0] += __ldcg(p);
  } else if constexpr (VEC == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    acc[0] += v.x;
    acc[1] += v.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + i));
      acc[i] += v.x;
      acc[i + 1] += v.y;
      acc[i + 2] += v.z;
      acc[i + 3] += v.w;
    }
  }
}

// adds the lane's VEC values of the fp32 partial row at p
template <int VEC, bool ANY>
__device__ __forceinline__ void add_partial(const float* p, float (&acc)[VEC],
                                            int lane, int nc) {
  if constexpr (ANY) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int c = col<VEC, ANY>(lane, i);
      if (c < nc) acc[i] += __ldcg(p + c);
    }
  } else {
    add_partial_vec<VEC>(p + lane * VEC, acc);
  }
}

// row key of flat slot s, or -1 for a padding slot or s outside [0, S)
__device__ __forceinline__ int key_at(const int* local, const int* block,
                                      int s, int S, int W) {
  if (s < 0 || s >= S) return -1;
  const int loc = local[s];
  return loc < kTableBlock ? block[s / W] * kTableBlock + loc : -1;
}

// the warp writes zero rows [lo, min(hi, out_rows)) of the slab at out
// (rows `ld` elements apart, nc columns)
template <typename T, int VEC, bool ANY>
__device__ __forceinline__ void zero_rows(T* out, long long ld, int nc, int lo,
                                          int hi, int out_rows, int lane) {
  float z[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) z[i] = 0.0f;
  const int end = hi < out_rows ? hi : out_rows;
  for (int r = lo; r < end; ++r)
    put_row<T, VEC, ANY>(out + static_cast<long long>(r) * ld, z, lane, nc);
}

// Ticket word of a run that crosses block edges, from block b to block e:
// every block of the run adds one to the count (bits 42-63); block b also
// adds b+1 to bits 21-41 and block e adds e+1 to bits 0-20. The blocks are
// fewer than 2^21, so no field carries into the next, and the word is whole
// (both ends in, count e-b+1) only when the last block of the run adds.
constexpr int kField = 21;
constexpr unsigned long long kFieldMask = (1ull << kField) - 1;
constexpr unsigned long long kOne = 1ull << (2 * kField);
constexpr long long kMaxBlocks = (1ll << kField) - 1;

__device__ __forceinline__ bool ticket_whole(unsigned long long w, int* b,
                                             int* e) {
  const int lo = static_cast<int>((w >> kField) & kFieldMask);
  const int hi = static_cast<int>(w & kFieldMask);
  *b = lo - 1;
  *e = hi - 1;
  return lo > 0 && hi > 0 &&
         static_cast<long long>(w >> (2 * kField)) == hi - lo + 1;
}

constexpr int kShortRun = 4;  // runs over at most this many edges: per column

// The block sums `row`'s run from block b's tail partial and the head or
// through partials of blocks b+1..e, in an order fixed by b and e alone.
// A short run: one column a thread, the partials in block order. A longer
// one: warp 0 starts with the tail, warp w takes blocks b+1+w,
// b+1+w+kWarps, ... over kPar accumulators round-robin, and the warps'
// sums are added in warp order.
template <typename T, int VEC, bool ANY>
__device__ void finish_run(int row, int b, int e, const float* partials,
                           float (*s_acc)[32 * VEC], T* out, long long ld,
                           int nc, int out_rows) {
  constexpr int D = 32 * VEC;            // partial row width
  constexpr int kPar = VEC > 4 ? 1 : 4;  // partial rows in flight per warp
  if (e - b <= kShortRun) {
    if (threadIdx.x < nc && row < out_rows) {
      const int c = threadIdx.x;
      float v[kShortRun + 1];
#pragma unroll
      for (int k = 0; k <= kShortRun; ++k)
        v[k] = k == 0 ? __ldcg(partials + (2LL * b + 1) * D + c)
               : b + k <= e ? __ldcg(partials + 2LL * (b + k) * D + c)
                            : 0.0f;
      float sum = v[0];
#pragma unroll
      for (int k = 1; k <= kShortRun; ++k)
        if (b + k <= e) sum += v[k];
      out[static_cast<long long>(row) * ld + c] = from_float<T>(sum);
    }
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc[kPar][VEC];
#pragma unroll
  for (int q = 0; q < kPar; ++q)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[q][i] = 0.0f;
  if (warp == 0)
    add_partial<VEC, ANY>(partials + (2LL * b + 1) * D, acc[0], lane, nc);
  for (int j = b + 1 + warp; j <= e; j += kPar * kWarps) {
#pragma unroll
    for (int q = 0; q < kPar; ++q)
      if (j + q * kWarps <= e)
        add_partial<VEC, ANY>(partials + 2LL * (j + q * kWarps) * D, acc[q],
                              lane, nc);
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float sum = acc[0][i];
#pragma unroll
    for (int q = 1; q < kPar; ++q) sum += acc[q][i];
    s_acc[warp][col<VEC, ANY>(lane, i)] = sum;
  }
  __syncthreads();
  if (threadIdx.x < nc && row < out_rows) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_acc[w][threadIdx.x];
    out[static_cast<long long>(row) * ld + threadIdx.x] = from_float<T>(sum);
  }
  __syncthreads();
}

// SW slots a warp; D = 256 keeps two blocks per SM: its rows take more
// registers, and so do the general path's at VEC = 4 (its scalar loads
// spill at three blocks a SM). The fast set (ANY false) reads rows of
// exactly D = 32 * VEC columns; the general path one slab: columns
// [c0, c0 + nc) of rows ld elements long, nc <= 32 * VEC.
template <typename T, int VEC, int SW, bool ANY>
__global__ void __launch_bounds__(kThreads,
                                  VEC > 4 || (ANY && VEC == 4) ? 2 : 3)
segment_rows(const T* __restrict__ g, const int* __restrict__ pos,
             const int* __restrict__ local, const int* __restrict__ block,
             T* __restrict__ out, float* __restrict__ partials,
             unsigned long long* __restrict__ tickets, int n_ids,
             int out_rows, int S, int W, int ld_, int c0, int nc_) {
  constexpr int D = 32 * VEC;  // columns the lanes hold; partial row width
  const long long ld = ANY ? ld_ : D;  // row stride of g and out
  const int nc = ANY ? nc_ : D;        // columns of this slab
  if constexpr (ANY) {
    g += c0;
    out += c0;
  }
  constexpr int kChunk = SW < 32 ? SW : 32;  // slots a warp loads at once
  // cotangent rows in flight per warp: 32 bytes a lane (divides kChunk)
  constexpr int kRows = VEC * sizeof(T) >= 16 ? 2 : 4;
  __shared__ __align__(16) float s_piece[2][kWarps][D];  // first, last run
  __shared__ int s_key[kWarps];                          // key of [1]
  __shared__ int s_state[kWarps];
  __shared__ int s_head;    // row of the run that enters the block, or -1
  __shared__ int s_fin[2][3];  // runs this block sums last: row, b, e

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const int s0 = (b * kWarps + warp) * SW;
  const int s1 = s0 < S - SW ? s0 + SW : S;
  int state = 0;

  if (s0 < S) {
    state = kBusy;
    int cur = -1;        // row of the run being summed
    bool first = false;  // `cur` began before this warp's range
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;

    // the range in chunks of up to 32 slots, one to a lane
#pragma unroll 1
    for (int ch = 0; ch < SW / kChunk; ++ch) {
      const int c0 = s0 + ch * kChunk;
      if (c0 >= s1) break;
      // this lane's slot: its row key and pos, -1 for a padding slot (whose
      // pos is never read) or a slot past s1; a pos outside g adds nothing
      const int s = c0 + lane;
      int key = -1, p_lane = -1;
      if (s < s1) {
        const int loc = local[s];
        if (loc < kTableBlock) {
          key = block[s / W] * kTableBlock + loc;
          const int q = pos[s];
          p_lane = q >= 0 && q < n_ids ? q : -1;
        }
      }
      // lane 0: the key of the slot before the chunk
      const int k_before = lane == 0 ? key_at(local, block, c0 - 1, S, W) : -1;
      if (ch == 0) {
        const int k_first = __shfl_sync(kFull, key, 0);
        if (k_first >= 0 && __shfl_sync(kFull, k_before, 0) == k_first) {
          state |= kOpenStart;
          cur = k_first;
          first = true;
        }
        if (warp == 0 && lane == 0) s_head = first ? k_first : -1;
      }

#pragma unroll 1
      for (int k0 = 0; k0 < kChunk; k0 += kRows) {
        Pack<T, VEC> v[kRows];  // raw rows, converted as they are added
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int p = __shfl_sync(kFull, p_lane, k0 + u);
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[u].x[i] = from_float<T>(0.0f);
          if (p >= 0) {
            const T* row = g + static_cast<long long>(p) * ld;
            if constexpr (ANY) {
#pragma unroll
              for (int i = 0; i < VEC; ++i)
                if (col<VEC, ANY>(lane, i) < nc)
                  v[u].x[i] = row[col<VEC, ANY>(lane, i)];
            } else {
              v[u] = *reinterpret_cast<const Pack<T, VEC>*>(row + lane * VEC);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int k = __shfl_sync(kFull, key, k0 + u);
          if (k < 0) continue;
          if (k != cur) {
            if (cur >= 0) {  // the run `cur` ended inside this range
              if (first)
                put_row<float, VEC, ANY>(s_piece[0][warp], acc, lane, nc);
              else if (cur < out_rows)
                put_row<T, VEC, ANY>(out + static_cast<long long>(cur) * ld,
                                     acc, lane, nc);
            }
            cur = k;
            first = false;
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
          }
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += to_float(v[u].x[i]);
        }
      }

      // zero fill owed by this lane's slot: rows no slot names
      int kp = __shfl_up_sync(kFull, key, 1);
      if (lane == 0) kp = k_before;
      int kn = __shfl_down_sync(kFull, key, 1);
      if (s < s1 && (lane == 31 || s + 1 == s1))
        kn = key_at(local, block, s + 1, S, W);
      int lo = 0, hi = 0, lo2 = 0, hi2 = 0;
      if (s < s1) {
        if (key >= 0) {
          if (kp != key) {  // a run begins: rows since the last real slot's
            lo = kp >= 0 ? kp + 1 : key & ~(kTableBlock - 1);
            hi = key;
          }
          if (kn < 0) {  // padding or the end follows: rest of the block
            lo2 = key + 1;
            hi2 = (key | (kTableBlock - 1)) + 1;
          }
        } else if (s % W == 0) {  // a tile of padding only
          const int t = s / W;
          const int bt = block[t];
          if (t == 0 || block[t - 1] != bt) {  // its table block has no ids
            lo = bt * kTableBlock;
            hi = lo + kTableBlock;
          }
        }
      }
      for (unsigned m = __ballot_sync(kFull, lo < hi || lo2 < hi2); m;
           m &= m - 1) {
        const int src = __ffs(m) - 1;
        zero_rows<T, VEC, ANY>(out, ld, nc, __shfl_sync(kFull, lo, src),
                               __shfl_sync(kFull, hi, src), out_rows, lane);
        zero_rows<T, VEC, ANY>(out, ld, nc, __shfl_sync(kFull, lo2, src),
                               __shfl_sync(kFull, hi2, src), out_rows, lane);
      }
    }

    const bool open_end = cur >= 0 && key_at(local, block, s1, S, W) == cur;
    if (cur >= 0) {
      if (first || open_end) {
        put_row<float, VEC, ANY>(s_piece[first ? 0 : 1][warp], acc, lane, nc);
        if (!first && lane == 0) s_key[warp] = cur;
      } else if (cur < out_rows) {
        put_row<T, VEC, ANY>(out + static_cast<long long>(cur) * ld, acc,
                             lane, nc);
      }
    }
    state |= (open_end ? kOpenEnd : 0) | (first && open_end ? kWhole : 0);
  }
  if (b == 0 && warp == 0)  // rows past the plan's last table block
    zero_rows<T, VEC, ANY>(out, ld, nc, (block[S / W - 1] + 1) * kTableBlock,
                           out_rows, out_rows, lane);
  if (lane == 0) s_state[warp] = state;
  __syncthreads();

  // the block sums the pieces of runs that cross its warp edges, in warp
  // order, one column per thread
  int fl = 0, tail_row = -1;
  if (threadIdx.x < nc) {
    const int c = threadIdx.x;
    float acc = 0.0f;
    int key = -1;
    bool open = false, earlier = false;  // a run is open; begun before b
    for (int w = 0; w < kWarps; ++w) {
      const int st = s_state[w];
      if (!(st & kBusy)) break;
      if (st & kOpenStart) {
        if (w == 0) {
          open = earlier = true;
          acc = 0.0f;
        }
        acc += s_piece[0][w][c];
        if (st & kWhole) continue;
        if (earlier) {
          partials[2LL * b * D + c] = acc;
          fl |= kHead;
        } else if (key < out_rows) {
          out[static_cast<long long>(key) * ld + c] = from_float<T>(acc);
        }
        open = false;
      }
      if (st & kOpenEnd) {
        acc = s_piece[1][w][c];
        key = s_key[w];
        open = true;
        earlier = false;
      }
    }
    if (open) {
      partials[(2LL * b + (earlier ? 0 : 1)) * D + c] = acc;
      fl |= earlier ? kThrough : kTail;
      if (!earlier) tail_row = key;
    }
  }
  __syncthreads();

  // tickets: the block whose add makes a crossing run's word whole sums the
  // run and sets the word back to 0 (a row past out_rows, which a plan from
  // make_gather_plan never names, is skipped by every block of its run
  // alike). One thread publishes the block's partials, as a grid barrier
  // does: barrier, fence, atomic.
  if (threadIdx.x == 0) {
    s_fin[0][0] = s_fin[1][0] = -1;
    const bool enter = (fl & (kHead | kThrough)) && s_head < out_rows;
    const bool leave = (fl & kTail) && tail_row < out_rows;
    if (enter || leave) {
      __threadfence();
      bool whole = false;
      for (int k = 0; k < 2; ++k) {
        const int row = k == 0 ? s_head : tail_row;
        if (!(k == 0 ? enter : leave)) continue;
        const unsigned long long add =
            kOne + (k == 1 ? static_cast<unsigned long long>(b + 1) << kField
                    : fl & kHead ? static_cast<unsigned long long>(b + 1)
                                 : 0ull);
        const unsigned long long w = atomicAdd(tickets + row, add) + add;
        if (ticket_whole(w, &s_fin[k][1], &s_fin[k][2])) {
          s_fin[k][0] = row;
          tickets[row] = 0;
          whole = true;
        }
      }
      if (whole) __threadfence();
    }
  }
  __syncthreads();
  for (int k = 0; k < 2; ++k)
    if (s_fin[k][0] >= 0)
      finish_run<T, VEC, ANY>(s_fin[k][0], s_fin[k][1], s_fin[k][2],
                              partials, s_piece[0], out, ld, nc, out_rows);
}

template <typename T, int VEC, int SW, bool ANY>
cudaError_t launch(const void* g, const int* pos, const int* local,
                   const int* block, void* out, float* partials,
                   unsigned long long* tickets, int n_ids, int out_rows,
                   int S, int W, int ld, int c0, int nc, int n_blocks,
                   cudaStream_t s) {
  segment_rows<T, VEC, SW, ANY><<<n_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(g), pos, local, block, static_cast<T*>(out),
      partials, tickets, n_ids, out_rows, S, W, ld, c0, nc);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const int*, const int*,
                               const int*, void*, float*,
                               unsigned long long*, int, int, int, int, int,
                               int, int, int, cudaStream_t);

// the instantiation for lanes of vec columns and sw slots a warp, or nullptr
template <typename T, bool ANY>
Launch pick(int vec, int sw) {
  static constexpr Launch kTable[4][4] = {
      {launch<T, 1, 8, ANY>, launch<T, 1, 16, ANY>, launch<T, 1, 32, ANY>,
       launch<T, 1, 64, ANY>},
      {launch<T, 2, 8, ANY>, launch<T, 2, 16, ANY>, launch<T, 2, 32, ANY>,
       launch<T, 2, 64, ANY>},
      {launch<T, 4, 8, ANY>, launch<T, 4, 16, ANY>, launch<T, 4, 32, ANY>,
       launch<T, 4, 64, ANY>},
      {launch<T, 8, 8, ANY>, launch<T, 8, 16, ANY>, launch<T, 8, 32, ANY>,
       launch<T, 8, 64, ANY>}};
  const int v = vec == 1 ? 0 : vec == 2 ? 1 : vec == 4 ? 2 : vec == 8 ? 3 : -1;
  const int w = sw == 8 ? 0 : sw == 16 ? 1 : sw == 32 ? 2 : sw == 64 ? 3 : -1;
  return v < 0 || w < 0 ? nullptr : kTable[v][w];
}

Launch pick(bool bf16, bool any, int vec, int sw) {
  return bf16 ? (any ? pick<__nv_bfloat16, true>(vec, sw)
                     : pick<__nv_bfloat16, false>(vec, sw))
              : (any ? pick<float, true>(vec, sw)
                     : pick<float, false>(vec, sw));
}

constexpr int kSlab = 256;  // columns of a general-path slab

// columns a lane holds for a slab of nc <= 256 columns: the least of 32,
// 64, 128 and 256 that is at least nc, over 32 (D / 32 in the fast set)
int slab_vec(int nc) {
  return nc <= 32 ? 1 : nc <= 64 ? 2 : nc <= 128 ? 4 : 8;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t; 0 = ok.
// g (n_ids, D) and out (out_rows, D) both f32, or both bf16 (bf16), each
// contiguous; D >= 1; pos/local (T, W) i32; block (T,) i32. D of 32, 64, 128
// or 256 with g and out 16-byte aligned takes the fast set, every other D
// (or alignment) the general path, one launch per slab of up to 256
// columns. slots_per_warp is 8, 16, 32 or 64, and the grid is ceil(T*W /
// (16 * slots_per_warp)) blocks, fewer than 2^21. scratch (scratch_bytes)
// holds 2 fp32 partial rows a block, each 32 * slab_vec(min(D, 256))
// floats wide (D itself in the fast set); tickets holds ticket_rows 64-bit
// words, at least out_rows, zero on entry and left zero.
extern "C" int subgnn_segment_matmul(const void* g, const void* pos,
                                     const void* local, const void* block,
                                     void* out, long long n_ids,
                                     long long out_rows, int T, int W, int D,
                                     int bf16, int slots_per_warp,
                                     void* scratch, long long scratch_bytes,
                                     void* tickets, long long ticket_rows,
                                     void* stream) {
  if (out_rows <= 0) return 0;
  const int sw = slots_per_warp;
  const bool aligned = reinterpret_cast<unsigned long long>(g) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(out) % 16 == 0;
  const bool any = !(aligned && (D == 32 || D == 64 || D == 128 || D == 256));
  const int width = 32 * slab_vec(D < kSlab ? D : kSlab);  // partial row
  if (D <= 0 || W <= 0 || T < 0 || pick(bf16, any, width / 32, sw) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const long long S = static_cast<long long>(T) * W;
  if (S == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(out_rows) * D * (bf16 ? 2 : 4), s));
  // slots, rows and ids are int on the card, blocks fit a ticket field
  const long long n_blocks = (S + kWarps * sw - 1) / (kWarps * sw);
  if (S > 0x7fffffffLL - kWarps * 64 || out_rows > 0x7fffffffLL ||
      n_ids > 0x7fffffffLL || n_blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (scratch_bytes < 2 * n_blocks * width * 4 || ticket_rows < out_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  // the slabs one after another on the stream (the fast set is one slab)
  for (int c0 = 0; c0 < D; c0 += kSlab) {
    const int nc = D - c0 < kSlab ? D - c0 : kSlab;
    const int err = static_cast<int>(pick(bf16, any, slab_vec(nc), sw)(
        g, static_cast<const int*>(pos), static_cast<const int*>(local),
        static_cast<const int*>(block), out, static_cast<float*>(scratch),
        static_cast<unsigned long long*>(tickets), static_cast<int>(n_ids),
        static_cast<int>(out_rows), static_cast<int>(S), W, D, c0, nc,
        static_cast<int>(n_blocks), s));
    if (err != 0) return err;
  }
  return 0;
}
