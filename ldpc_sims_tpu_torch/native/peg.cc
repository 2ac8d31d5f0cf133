// Progressive Edge Growth (PEG) LDPC graph construction.
//
// The port's own copy of ldpc_sims_tpu/native/peg.cc: the same algorithm
// and PRNG, so the same graph for the same seed.
//
// Native-core counterpart of the Python PEG in codes/library.py: the
// reference project has no code constructor at all (its one matrix came
// from an external web tool, bp/parity.py:1-3); large custom codes need a
// fast builder, and BFS-per-edge over the bipartite graph is exactly the
// kind of host-side graph work that belongs in C++ (O(n * col_deg * E)).
//
// Algorithm (Hu, Eleftheriou, Arnold 2005): variables are processed in a
// seeded pseudo-random order; each new edge attaches to a check node at
// maximal BFS distance from the variable (unreached checks first), ties
// broken by lowest current check degree, then lowest index. No parallel
// edges; guarantees girth > 4 while the graph is sparse enough.
//
// Build:  g++ -O3 -shared -fPIC -o libpeg.so peg.cc (the package's
//         loader does so into build/native/ of the checkout on first use)
// ABI:    peg_construct(n, m, col_deg, seed, out) -> 0 on success;
//         out is int32[n * col_deg] listing the checks of each variable.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

// xorshift64* PRNG — deterministic across platforms.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed * 2685821657736338717ULL + 1) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 2685821657736338717ULL;
  }
  // unbiased bounded draw
  uint64_t bounded(uint64_t n) {
    uint64_t t = (-n) % n;
    for (;;) {
      uint64_t r = next();
      if (r >= t) return r % n;
    }
  }
};

}  // namespace

extern "C" int peg_construct(int32_t n, int32_t m, int32_t col_deg,
                             uint64_t seed, int32_t* out) {
  if (n <= 0 || m <= 0 || col_deg <= 0 || col_deg > m) return 1;
  std::vector<std::vector<int32_t>> adj_v(n), adj_c(m);
  std::vector<int64_t> c_deg(m, 0);

  // seeded Fisher-Yates variable order
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  Rng rng(seed + 0x9E3779B97F4A7C15ULL);
  for (int32_t i = n - 1; i > 0; --i) {
    int32_t j = static_cast<int32_t>(rng.bounded(i + 1));
    std::swap(order[i], order[j]);
  }

  std::vector<int32_t> dist(m);
  std::vector<uint8_t> seen_v(n);
  constexpr int32_t kInf = INT32_MAX;

  for (int32_t vi = 0; vi < n; ++vi) {
    int32_t v = order[vi];
    for (int32_t e = 0; e < col_deg; ++e) {
      // BFS from v over the current bipartite graph, check distances
      std::fill(dist.begin(), dist.end(), kInf);
      std::fill(seen_v.begin(), seen_v.end(), 0);
      seen_v[v] = 1;
      std::vector<int32_t> frontier;
      for (int32_t c : adj_v[v]) {
        if (dist[c] == kInf) {
          dist[c] = 0;
          frontier.push_back(c);
        }
      }
      int32_t d = 0;
      while (!frontier.empty()) {
        std::vector<int32_t> nxt;
        for (int32_t c : frontier) {
          for (int32_t v2 : adj_c[c]) {
            if (!seen_v[v2]) {
              seen_v[v2] = 1;
              for (int32_t c2 : adj_v[v2]) {
                if (dist[c2] > d + 1) {
                  dist[c2] = d + 1;
                  nxt.push_back(c2);
                }
              }
            }
          }
        }
        frontier.swap(nxt);
        ++d;
      }
      // candidate set: unreached checks, else the farthest ones;
      // exclude checks already joined to v
      int32_t best = -1;
      int32_t best_dist = -1;
      for (int32_t c = 0; c < m; ++c) {
        bool joined = false;
        for (int32_t c2 : adj_v[v])
          if (c2 == c) { joined = true; break; }
        if (joined) continue;
        int32_t dc = dist[c];  // kInf = unreached = best possible
        if (best == -1 || dc > best_dist ||
            (dc == best_dist && (c_deg[c] < c_deg[best] ||
                                 (c_deg[c] == c_deg[best] && c < best)))) {
          best = c;
          best_dist = dc;
        }
      }
      if (best < 0) return 2;  // no eligible check
      adj_v[v].push_back(best);
      adj_c[best].push_back(v);
      ++c_deg[best];
    }
  }

  for (int32_t v = 0; v < n; ++v)
    for (int32_t e = 0; e < col_deg; ++e) out[v * col_deg + e] = adj_v[v][e];
  return 0;
}
