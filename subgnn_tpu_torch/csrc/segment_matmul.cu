// Gradient of an embedding-table gather, routed by a host-built gather plan.
//
// Replaces the Pallas TPU kernel subgnn_tpu/ops/embedding.py:150
// (_segment_matmul_pallas: per 512-slot tile, onehot(local)^T @ g[pos] into
// the tile's 128-row table block, tiles of one block accumulated in place in
// VMEM while the grid walks them in order on one core). Same result:
//   dtable[block*128 + local] = sum over the plan's slots of g[pos]   (fp32)
// written in the cotangent's dtype, which is the table's (fp32 or bf16);
// rows no slot names are 0.
//
// The plan (subgnn_tpu_torch/ops/embedding.py:make_gather_plan): pos/local
// (T, W) int32, block (T,) int32 non-decreasing. The slots of one table block
// are its ids sorted (stable argsort) and cut into consecutive tiles, so over
// the flat (T*W) slot array the row key (block, local) is non-decreasing and
// every row's slots form ONE contiguous run. Padding slots (local == 128)
// come only at the end of a block's last tile and in padding tiles.
//
// What bounds it on an H100: bytes. Each real slot reads one D-wide
// cotangent row (at B=1280 bf16 the neigh plan reads 345,600 x 128 x 2 B =
// 88.5 MB, plus ~2.9 MB of pos/local and ~2.1 MB of output: ~0.028 ms at
// 3.35 TB/s); the adds are one fp32 flop per element read. The TPU's one-hot
// product spent 128x that arithmetic; a direct row accumulate does not.
//
// Design (simple and deterministic first):
//   * pass 1: the flat slot array is cut into chunks of 128 slots (a tile is
//     4 chunks, so a chunk never spans two table blocks); one warp walks one
//     chunk in order. Lane l holds columns [l*VEC, l*VEC+VEC) of the running
//     row sum in registers (VEC = D/32); the warp loads 32 pos/local values
//     at once and broadcasts them with __shfl_sync, with 8 row loads in
//     flight. Padding slots are skipped by local and their pos is never
//     read, so the caller needs no zero row appended to the cotangent.
//     A run that starts and ends inside the chunk is the row's whole
//     gradient: it is written straight to the output. A run that crosses the
//     chunk's first or last slot is written as an fp32 partial (head/tail)
//     into scratch, with per-chunk flags.
//   * pass 2: one block per chunk; it works only where a crossing run starts
//     (hub rows: the PAD row holds a third of the neigh slots). Its 8 warps
//     sum that run's partials in a fixed strided order, then combine in
//     shared memory in warp order, and write the row.
//   * no atomics anywhere: every output row has exactly one writer and every
//     sum has a fixed order, so the same plan and cotangent give the same
//     bits on every run (index_add_ and float atomicAdd do not).
//   * the output is zeroed with cudaMemsetAsync first (rows without slots,
//     and table rows past the plan).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTableBlock = 128;  // rows per table block (TABLE_BLOCK)
constexpr int kChunk = 128;       // plan slots per warp in pass 1
constexpr int kWarps = 8;         // warps per thread block, both passes
constexpr int kUnroll = 8;        // cotangent rows in flight per warp
constexpr int kPar = 4;           // independent partial sums per warp, pass 2
constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

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
__device__ __forceinline__ void load_row(const T* p, float (&v)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_float(pk.x[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float (&v)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.x[i] = from_float<T>(v[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// flag bits per chunk
constexpr int kOpenEnd = 1;  // the chunk's last run continues into the next
constexpr int kCont = 2;     // the chunk holds one run only, begun earlier

// row key of flat slot s, or -1 for a padding slot
__device__ __forceinline__ long long slot_key(const int* local,
                                              const int* block, long long s,
                                              int W) {
  const int loc = local[s];
  return loc < kTableBlock ? static_cast<long long>(block[s / W]) * kTableBlock + loc
                           : -1;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
segment_pass1(const T* __restrict__ g, const int* __restrict__ pos,
              const int* __restrict__ local, const int* __restrict__ block,
              T* __restrict__ out, float* __restrict__ partials,
              int* __restrict__ flags, long long n_ids, long long out_rows,
              long long n_chunks, int W, int D) {
  const int lane = threadIdx.x & 31;
  const long long chunk =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // uniform across the warp
  const long long s0 = chunk * kChunk;
  const long long total = n_chunks * kChunk;
  const long long row0 = static_cast<long long>(block[s0 / W]) * kTableBlock;

  const long long first_key = slot_key(local, block, s0, W);
  const long long last_key = slot_key(local, block, s0 + kChunk - 1, W);
  const bool open_start =
      first_key >= 0 && s0 > 0 && slot_key(local, block, s0 - 1, W) == first_key;
  const bool open_end = last_key >= 0 && s0 + kChunk < total &&
                        slot_key(local, block, s0 + kChunk, W) == last_key;

  float* head_part = partials + (2 * chunk) * D + lane * VEC;
  float* tail_part = partials + (2 * chunk + 1) * D + lane * VEC;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  int cur = -1;            // local row of the run being summed; -1 = none
  bool head = open_start;  // that run began in an earlier chunk

  for (int base = 0; base < kChunk; base += 32) {
    const int my_loc = local[s0 + base + lane];
    const int my_pos = my_loc < kTableBlock ? pos[s0 + base + lane] : 0;
    for (int k0 = 0; k0 < 32; k0 += kUnroll) {
      float v[kUnroll][VEC];
      int loc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        loc[u] = __shfl_sync(kFull, my_loc, k0 + u);
        const int p = __shfl_sync(kFull, my_pos, k0 + u);
        if (loc[u] < kTableBlock && p >= 0 && p < n_ids) {
          load_row<T, VEC>(g + static_cast<long long>(p) * D + lane * VEC,
                             v[u]);
        } else {
          loc[u] = kTableBlock;  // padding (or a slot outside g): skip
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (loc[u] >= kTableBlock) continue;
        if (loc[u] != cur) {
          if (cur >= 0) {  // the run `cur` ended inside this chunk
            if (head) {
              store_row<float, VEC>(head_part, acc);
            } else if (row0 + cur < out_rows) {
              store_row<T, VEC>(out + (row0 + cur) * D + lane * VEC, acc);
            }
            head = false;
          }
          cur = loc[u];
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += v[u][i];
      }
    }
  }

  const bool cont = head && cur >= 0;
  if (cur >= 0) {
    if (head) {
      store_row<float, VEC>(head_part, acc);
    } else if (open_end) {
      store_row<float, VEC>(tail_part, acc);
    } else if (row0 + cur < out_rows) {
      store_row<T, VEC>(out + (row0 + cur) * D + lane * VEC, acc);
    }
  }
  if (lane == 0) flags[chunk] = (open_end ? kOpenEnd : 0) | (cont ? kCont : 0);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
segment_pass2(const int* __restrict__ local, const int* __restrict__ block,
              const float* __restrict__ partials,
              const int* __restrict__ flags, T* __restrict__ out,
              long long out_rows, long long n_chunks, int W, int D) {
  const long long c0 = blockIdx.x;
  // only the chunk where a run crossing a chunk edge begins does any work
  const int f0 = flags[c0];
  if (!(f0 & kOpenEnd) || (f0 & kCont)) return;

  __shared__ long long s_end;
  __shared__ float s_acc[kWarps][kMaxD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    // the run goes on through chunks flagged kCont|kOpenEnd and ends in the
    // first chunk that is not (its head partial is the run's last piece)
    long long end = -1;
    for (long long c = c0 + 1; end < 0; c += 32) {
      const long long cc = c + lane;
      const bool stop = cc >= n_chunks || flags[cc] != (kCont | kOpenEnd);
      const unsigned m = __ballot_sync(kFull, stop);
      if (m) end = c + __ffs(m) - 1;
    }
    if (lane == 0) s_end = end < n_chunks ? end : n_chunks - 1;
  }
  __syncthreads();
  const long long c_end = s_end;

  float acc[kPar][VEC];
#pragma unroll
  for (int j = 0; j < kPar; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[j][i] = 0.0f;
  if (warp == 0) load_row<float, VEC>(partials + (2 * c0 + 1) * D + lane * VEC,
                                      acc[0]);
  // warp w takes head partials c0+1+w, c0+1+w+kWarps, ... round-robin over
  // kPar accumulators (a fixed order, so the sum is the same every run)
  long long c = c0 + 1 + warp;
  for (; c + (kPar - 1) * kWarps <= c_end; c += kPar * kWarps) {
    float v[kPar][VEC];
#pragma unroll
    for (int j = 0; j < kPar; ++j)
      load_row<float, VEC>(partials + (2 * (c + j * kWarps)) * D + lane * VEC,
                           v[j]);
#pragma unroll
    for (int j = 0; j < kPar; ++j)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[j][i] += v[j][i];
  }
  for (; c <= c_end; c += kWarps) {
    float v[VEC];
    load_row<float, VEC>(partials + (2 * c) * D + lane * VEC, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[0][i] += v[i];
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float s = acc[0][i];
#pragma unroll
    for (int j = 1; j < kPar; ++j) s += acc[j][i];
    s_acc[warp][lane * VEC + i] = s;
  }
  __syncthreads();

  const long long last = c0 * kChunk + kChunk - 1;  // the run's first chunk ends in it
  const long long row =
      static_cast<long long>(block[last / W]) * kTableBlock + local[last];
  for (int t = threadIdx.x; t < D; t += blockDim.x) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_acc[w][t];
    if (row < out_rows) out[row * D + t] = from_float<T>(s);
  }
}

template <typename T, int VEC>
cudaError_t run(const void* g, const int* pos, const int* local,
                const int* block, void* out, float* partials, int* flags,
                long long n_ids, long long out_rows, long long n_chunks,
                int W, int D, cudaStream_t s) {
  const long long grid1 = (n_chunks + kWarps - 1) / kWarps;
  segment_pass1<T, VEC><<<static_cast<unsigned>(grid1), kWarps * 32, 0, s>>>(
      static_cast<const T*>(g), pos, local, block, static_cast<T*>(out),
      partials, flags, n_ids, out_rows, n_chunks, W, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_pass2<T, VEC><<<static_cast<unsigned>(n_chunks), kWarps * 32, 0,
                          s>>>(local, block, partials, flags,
                               static_cast<T*>(out), out_rows, n_chunks, W, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_vec(int vec, const void* g, const int* pos, const int* local,
                    const int* block, void* out, float* partials, int* flags,
                    long long n_ids, long long out_rows, long long n_chunks,
                    int W, int D, cudaStream_t s) {
  switch (vec) {
    case 1:
      return run<T, 1>(g, pos, local, block, out, partials, flags, n_ids,
                         out_rows, n_chunks, W, D, s);
    case 2:
      return run<T, 2>(g, pos, local, block, out, partials, flags, n_ids,
                         out_rows, n_chunks, W, D, s);
    case 4:
      return run<T, 4>(g, pos, local, block, out, partials, flags, n_ids,
                         out_rows, n_chunks, W, D, s);
    case 8:
      return run<T, 8>(g, pos, local, block, out, partials, flags, n_ids,
                         out_rows, n_chunks, W, D, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t; 0 = ok.
// g (n_ids, D) and out (out_rows, D) both f32, or both bf16 (bf16), g 16-byte
// aligned; pos/local (T, W) i32; block (T,) i32; partials (2 * T*W/128, D)
// f32 and flags (T*W/128,) i32 scratch. D is 32, 64, 128 or 256; W a
// multiple of 128.
extern "C" int subgnn_segment_matmul(const void* g, const void* pos,
                                     const void* local, const void* block,
                                     void* out, long long n_ids,
                                     long long out_rows, int T, int W, int D,
                                     int bf16, void* partials, void* flags,
                                     void* stream) {
  if (out_rows <= 0) return 0;
  if (D <= 0 || D % 32 || D > kMaxD || W <= 0 || W % kChunk || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t out_bytes = static_cast<size_t>(out_rows) * D * (bf16 ? 2 : 4);
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_chunks = static_cast<long long>(T) * W / kChunk;
  if (n_chunks == 0) return static_cast<int>(cudaGetLastError());
  if (n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int vec = D / 32;
  const auto* p = static_cast<const int*>(pos);
  const auto* l = static_cast<const int*>(local);
  const auto* b = static_cast<const int*>(block);
  auto* part = static_cast<float*>(partials);
  auto* fl = static_cast<int*>(flags);
  if (bf16)
    err = run_vec<__nv_bfloat16>(vec, g, p, l, b, out, part, fl, n_ids,
                                 out_rows, n_chunks, W, D, s);
  else
    err = run_vec<float>(vec, g, p, l, b, out, part, fl, n_ids, out_rows,
                         n_chunks, W, D, s);
  return static_cast<int>(err);
}
