// Native host-side kernels of subgnn_tpu_torch (C ABI, loaded via ctypes).
//
// The port's own copy of the JAX package's host library: the three entry
// points below are the same code, so the same graph gives the same hop
// distances and the same seed the same walks, bit for bit.
//
// The reference gets its host-side graph performance from third-party C++
// (SNAP for all-pairs BFS at prepare_dataset/precompute_graph_metrics.py:22,
// NetworkX-in-C loops elsewhere). This library supplies the same class of
// native performance for our CSR arrays:
//
//   * bfs_from_sources / bfs_all_pairs : multithreaded BFS over CSR from a
//     set of sources (or all of them), writing int32 hop-distance rows with
//     the reference's "unreached = 0" fill contract.
//   * triangular_walks_full : batched triangular random walks (rw_beta-biased
//     toward triangle-closing steps, anchor_patch_samplers.py:49-113
//     semantics) with a splitmix64/xoroshiro128+ PRNG seeded per (seed,
//     walk) — deterministic and order-independent.
//
// Build (subgnn_tpu_torch/ops/native.py, at first use, into build/native/):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread subgnn_native.cpp -o lib.so
// No -march=native: the library does integer work and exact double
// compares only, so the flag could not change a result, and without it a
// library built on one host loads on another.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- BFS

// indptr: int64[n_nodes+2] (1-based rows; row 0 empty)
// indices: int32[nnz] (1-based ids)
// sources: int32[n_src] (1-based start nodes)
// out: int32[n_src * n_nodes] (row i = distances from sources[i], raw
//      0-based destination columns), pre-zeroed by caller
void bfs_from_sources(const int64_t* indptr, const int32_t* indices,
                      int64_t n_nodes, const int32_t* sources, int64_t n_src,
                      int32_t* out, int32_t n_threads) {
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  std::atomic<int64_t> next_idx{0};
  auto worker = [&]() {
    std::vector<int32_t> frontier, next;
    std::vector<uint8_t> visited((size_t)n_nodes + 1);
    frontier.reserve(n_nodes);
    next.reserve(n_nodes);
    for (;;) {
      int64_t i = next_idx.fetch_add(1);
      if (i >= n_src) break;
      int64_t s = sources[i];
      std::memset(visited.data(), 0, visited.size());
      int32_t* dist = out + i * n_nodes;
      visited[s] = 1;
      frontier.clear();
      frontier.push_back((int32_t)s);
      int32_t d = 0;
      while (!frontier.empty()) {
        ++d;
        next.clear();
        for (int32_t v : frontier) {
          for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
            int32_t u = indices[e];
            if (!visited[u]) {
              visited[u] = 1;
              dist[u - 1] = d;
              next.push_back(u);
            }
          }
        }
        frontier.swap(next);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// out: int32[n_nodes * n_nodes] (raw 0-based [src, dst]), pre-zeroed by
// caller — the sources = {1..n} special case of bfs_from_sources
void bfs_all_pairs(const int64_t* indptr, const int32_t* indices,
                   int64_t n_nodes, int32_t* out, int32_t n_threads) {
  std::vector<int32_t> sources((size_t)n_nodes);
  for (int64_t v = 1; v <= n_nodes; ++v) sources[v - 1] = (int32_t)v;
  bfs_from_sources(indptr, indices, n_nodes, sources.data(), n_nodes, out,
                   n_threads);
}

// ---------------------------------------------------------------- PRNG

struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    // splitmix64 expansion of the seed into xoshiro state
    auto sm = [&seed]() {
      uint64_t z = (seed += 0x9e3779b97f4a7c15ULL);
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      return z ^ (z >> 31);
    };
    s0 = sm();
    s1 = sm();
  }
  uint64_t next() {  // xoroshiro128+
    uint64_t a = s0, b = s1;
    uint64_t r = a + b;
    b ^= a;
    s0 = ((a << 24) | (a >> 40)) ^ b ^ (b << 16);
    s1 = (b << 37) | (b >> 27);
    return r;
  }
  // unbiased bounded integer
  uint64_t below(uint64_t bound) {
    if (bound <= 1) return 0;
    uint64_t threshold = (-bound) % bound;
    for (;;) {
      uint64_t r = next();
      if (r >= threshold) return r % bound;
    }
  }
  double uniform() { return (next() >> 11) * 0x1.0p-53; }
};

// ------------------------------------------------------ triangular walks

static inline bool has_edge(const int64_t* indptr, const int32_t* indices,
                            int32_t u, int32_t v) {
  int64_t lo = indptr[u], hi = indptr[u + 1];
  while (lo < hi) {  // rows are sorted
    int64_t mid = (lo + hi) / 2;
    if (indices[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < indptr[u + 1] && indices[lo] == v;
}

// One triangular random walk restricted to `member` (or the full graph when
// member == nullptr). Returns the walk length written into out (<= walk_len).
static int32_t walk_one(const int64_t* indptr, const int32_t* indices,
                        const uint8_t* member, const int32_t* start_nodes,
                        int64_t n_starts, int32_t walk_len, double rw_beta,
                        Rng& rng, int32_t* out,
                        std::vector<int32_t>& nbrs,
                        std::vector<int32_t>& tri,
                        std::vector<int32_t>& non_tri) {
  auto restricted = [&](int32_t v) {
    nbrs.clear();
    for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
      int32_t u = indices[e];
      if (!member || member[u]) nbrs.push_back(u);
    }
  };
  int32_t prev = start_nodes[rng.below((uint64_t)n_starts)];
  restricted(prev);
  if (nbrs.empty()) {
    out[0] = prev;
    return 1;
  }
  int32_t curr = nbrs[rng.below(nbrs.size())];
  out[0] = prev;
  out[1] = curr;
  int32_t len = 2;
  for (int32_t k = 0; k < walk_len - 2; ++k) {
    restricted(curr);
    if (nbrs.empty()) break;
    tri.clear();
    non_tri.clear();
    for (int32_t u : nbrs) {
      // triangle test within the same restricted graph: u adjacent to prev
      bool t = (!member || member[u]) && has_edge(indptr, indices, prev, u) &&
               (!member || member[prev]);
      // membership of prev is guaranteed (it is on the walk); the edge test
      // suffices, but a border walk restricts prev's row too:
      if (member && t) t = member[u];
      (t ? tri : non_tri).push_back(u);
    }
    int32_t nxt;
    if (tri.empty())
      nxt = non_tri[rng.below(non_tri.size())];
    else if (non_tri.empty())
      nxt = tri[rng.below(tri.size())];
    else if (rng.uniform() <= rw_beta)
      nxt = tri[rng.below(tri.size())];
    else
      nxt = non_tri[rng.below(non_tri.size())];
    prev = curr;
    curr = nxt;
    out[len++] = nxt;
  }
  return len;
}

// Batched walks over the FULL graph (structure anchor-patch pool sampling).
// starts: candidate start nodes (all graph node ids). out shape:
// (n_walks, walk_len) int32 pre-zeroed (PAD=0).
void triangular_walks_full(const int64_t* indptr, const int32_t* indices,
                           const int32_t* starts, int64_t n_starts,
                           int64_t n_walks, int32_t walk_len, double rw_beta,
                           uint64_t seed, int32_t* out, int32_t n_threads) {
  if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
  std::atomic<int64_t> next_w{0};
  auto worker = [&]() {
    std::vector<int32_t> nbrs, tri, non_tri;
    for (;;) {
      int64_t w = next_w.fetch_add(1);
      if (w >= n_walks) break;
      Rng rng(seed * 0x100000001b3ULL + (uint64_t)w);
      walk_one(indptr, indices, nullptr, starts, n_starts, walk_len, rw_beta,
               rng, out + w * walk_len, nbrs, tri, non_tri);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
