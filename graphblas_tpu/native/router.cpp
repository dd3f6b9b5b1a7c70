// Clos-network router: 128-edge-coloring of regular bipartite multigraphs.
//
// This is the native runtime component of the permutation engine
// (graphblas_tpu/ops/permute.py).  The network moves data only in regular
// patterns (per-row 128-lane shuffles, tile transposes); an arbitrary
// permutation is realized as a Clos/Benes network whose middle-stage routing
// is a proper edge coloring of a k-regular bipartite multigraph — computed
// here by recursive Euler splitting (k -> k/2 -> ... -> 1), O(E log k) with
// O(V + E) scratch reused across all classes (per-class allocations would be
// O(V * k) and dominate at deep levels).
//
// The reference framework's native layer is SuiteSparse's C engine; this
// file plays the analogous role for the one genuinely sequential, pointer-
// chasing computation in our engine (Hierholzer circuit walks), which is
// ~100x slower in Python/numpy.
//
// Exposed via ctypes (no pybind11 in the image): plain C ABI.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Scratch {
  // vertex-indexed, allocated once; only entries for touched vertices are
  // ever written, and they are reset after each class.
  std::vector<int64_t> deg;    // degree within current class
  std::vector<int64_t> start;  // adjacency slot start
  std::vector<int64_t> cur;    // fill / walk cursor
  std::vector<int64_t> touched;
  // edge-indexed (local to class)
  std::vector<int64_t> adj;    // 2 * E_cls slots of local edge ids
  std::vector<uint8_t> used;
  std::vector<uint8_t> bits;
  // walk stacks
  std::vector<int64_t> vstack;
  std::vector<int64_t> estack;
  std::vector<int64_t> circuit;
};

// Split one class (2h-regular bipartite multigraph) into two h-regular
// halves by alternating edges along Euler circuits.  edge_ids[lo..hi) are
// global edge ids; writes a bit per LOCAL index into s.bits[0..len).
void euler_split(const int64_t *edge_ids, int64_t len, const int32_t *in_rows,
                 const int32_t *out_rows, int64_t R, Scratch &s) {
  s.touched.clear();
  for (int64_t t = 0; t < len; ++t) {
    const int64_t e = edge_ids[t];
    const int64_t u = in_rows[e];
    const int64_t v = R + out_rows[e];
    if (s.deg[u]++ == 0) s.touched.push_back(u);
    if (s.deg[v]++ == 0) s.touched.push_back(v);
  }
  int64_t acc = 0;
  for (const int64_t v : s.touched) {
    s.start[v] = acc;
    s.cur[v] = acc;
    acc += s.deg[v];
  }
  if ((int64_t)s.adj.size() < 2 * len) s.adj.resize(2 * len);
  if ((int64_t)s.used.size() < len) s.used.resize(len);
  if ((int64_t)s.bits.size() < len) s.bits.resize(len);
  std::memset(s.used.data(), 0, len);
  for (int64_t t = 0; t < len; ++t) {
    const int64_t e = edge_ids[t];
    s.adj[s.cur[in_rows[e]]++] = t;
    s.adj[s.cur[R + out_rows[e]]++] = t;
  }
  // walk pointers restart at slot starts; `cur` now holds slot ends
  for (const int64_t v : s.touched) {
    const int64_t end = s.cur[v];
    s.cur[v] = s.start[v];
    s.start[v] = end;  // start[] repurposed as end[]
  }

  for (const int64_t v0 : s.touched) {
    if (s.cur[v0] >= s.start[v0]) continue;
    s.vstack.clear();
    s.estack.clear();
    s.circuit.clear();
    s.vstack.push_back(v0);
    s.estack.push_back(-1);
    while (!s.vstack.empty()) {
      const int64_t v = s.vstack.back();
      int64_t p = s.cur[v];
      const int64_t pend = s.start[v];
      while (p < pend && s.used[s.adj[p]]) ++p;
      s.cur[v] = p;
      if (p == pend) {
        s.vstack.pop_back();
        const int64_t e_in = s.estack.back();
        s.estack.pop_back();
        if (e_in >= 0) s.circuit.push_back(e_in);
      } else {
        const int64_t t = s.adj[p];
        s.used[t] = 1;
        const int64_t e = edge_ids[t];
        const int64_t other =
            (v < R) ? (R + out_rows[e]) : static_cast<int64_t>(in_rows[e]);
        s.vstack.push_back(other);
        s.estack.push_back(t);
      }
    }
    uint8_t bit = 0;
    for (int64_t idx = static_cast<int64_t>(s.circuit.size()) - 1; idx >= 0; --idx) {
      s.bits[s.circuit[idx]] = bit;
      bit ^= 1;
    }
  }

  // reset vertex scratch for the next class
  for (const int64_t v : s.touched) {
    s.deg[v] = 0;
    s.start[v] = 0;
    s.cur[v] = 0;
  }
}

}  // namespace

extern "C" {

// Proper k-edge-coloring of a k-regular bipartite multigraph (k power of 2).
// in_rows/out_rows: E entries in [0, R).  colors: E entries out, in [0, k).
// Returns 0 on success.
int gbtpu_euler_color(const int32_t *in_rows, const int32_t *out_rows,
                      int64_t E, int64_t R, int32_t k, int32_t *colors) {
  if (k <= 0 || (k & (k - 1)) != 0) return 1;
  std::memset(colors, 0, sizeof(int32_t) * E);

  Scratch s;
  s.deg.assign(2 * R, 0);
  s.start.assign(2 * R, 0);
  s.cur.assign(2 * R, 0);
  s.touched.reserve(2 * R);

  // edges kept in one array, stably partitioned into classes level by level
  std::vector<int64_t> edges(E), next_edges(E);
  for (int64_t e = 0; e < E; ++e) edges[e] = e;
  std::vector<int64_t> bounds = {0, E}, next_bounds;

  int levels = 0;
  while ((1 << levels) < k) ++levels;

  std::vector<uint8_t> levelbits(E);
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  const int max_threads = hw > 0 ? hw : 4;

  for (int level = 0; level < levels; ++level) {
    const size_t nclasses = bounds.size() - 1;
    const int nthreads = static_cast<int>(
        nclasses < static_cast<size_t>(max_threads) ? nclasses : max_threads);
    if (nthreads <= 1) {
      for (size_t c = 0; c + 1 < bounds.size(); ++c) {
        const int64_t lo = bounds[c], hi = bounds[c + 1];
        euler_split(edges.data() + lo, hi - lo, in_rows, out_rows, R, s);
        std::memcpy(levelbits.data() + lo, s.bits.data(), hi - lo);
      }
    } else {
      // classes are independent: fan out with per-thread scratch
      std::atomic<size_t> next_class{0};
      auto worker = [&]() {
        Scratch ws;
        ws.deg.assign(2 * R, 0);
        ws.start.assign(2 * R, 0);
        ws.cur.assign(2 * R, 0);
        for (;;) {
          const size_t c = next_class.fetch_add(1);
          if (c + 1 >= bounds.size()) break;
          const int64_t lo = bounds[c], hi = bounds[c + 1];
          euler_split(edges.data() + lo, hi - lo, in_rows, out_rows, R, ws);
          std::memcpy(levelbits.data() + lo, ws.bits.data(), hi - lo);
        }
      };
      std::vector<std::thread> threads;
      threads.reserve(nthreads);
      for (int tix = 0; tix < nthreads; ++tix) threads.emplace_back(worker);
      for (auto &th : threads) th.join();
    }
    // serial stable partition into next level's classes
    next_bounds.clear();
    int64_t out_pos = 0;
    for (size_t c = 0; c + 1 < bounds.size(); ++c) {
      const int64_t lo = bounds[c], hi = bounds[c + 1];
      next_bounds.push_back(out_pos);
      for (int64_t t = lo; t < hi; ++t)
        if (!levelbits[t]) next_edges[out_pos++] = edges[t];
      next_bounds.push_back(out_pos);
      for (int64_t t = lo; t < hi; ++t)
        if (levelbits[t]) {
          const int64_t e = edges[t];
          colors[e] |= (1 << level);
          next_edges[out_pos++] = e;
        }
    }
    next_bounds.push_back(out_pos);
    bounds.swap(next_bounds);
    edges.swap(next_edges);
  }
  return 0;
}

// Host-side COO utilities (the hot graph-construction path; the reference
// uses numba-compiled helpers for the analogous conversions,
// core/ss/matrix.py:4169-4430).

// Stable counting sort by keys in [0, n); returns the permutation.
int gbtpu_counting_sort(const int32_t *keys, int64_t E, int64_t n,
                        int64_t *perm_out) {
  std::vector<int64_t> counts(n + 1, 0);
  for (int64_t e = 0; e < E; ++e) counts[keys[e] + 1]++;
  for (int64_t i = 0; i < n; ++i) counts[i + 1] += counts[i];
  for (int64_t e = 0; e < E; ++e) perm_out[counts[keys[e]]++] = e;
  return 0;
}

}  // extern "C"


extern "C" {

// Faster 128-edge-coloring via successor-pairing Euler splits.
//
// Standard Euler-split routing walks Hierholzer circuits over an adjacency
// structure rebuilt per class (gbtpu_euler_color above).  This variant uses
// the pairing formulation: keep the class's edges in two orders — EL
// (grouped by left vertex) and ER (grouped by right vertex).  Pair
// consecutive edges (i, i^1) in each order (valid: every vertex's per-class
// degree is even and segment starts stay even).  The union of the two
// pairings decomposes the class into even cycles over edges; alternating
// bits along each cycle is exactly an Euler split.  Per split level this is
// two linear position passes, one pointer walk with ~2 random reads per
// edge, and two segment-local stable partitions — no adjacency lists, no
// stacks, no used-flag scans.
int gbtpu_euler_color2(const int32_t *in_rows, const int32_t *out_rows,
                       int64_t E, int64_t R, int32_t k, int32_t *colors) {
  if (k <= 0 || (k & (k - 1)) != 0) return 1;
  std::memset(colors, 0, sizeof(int32_t) * E);
  if (E == 0 || k == 1) return 0;

  std::vector<int32_t> EL(E), ER(E), EL2(E), ER2(E);
  std::vector<int32_t> succL(E), succR(E), g(E);
  std::vector<uint8_t> bits(E), visited(E);

  // initial orders: counting sort by left / right vertex
  {
    std::vector<int64_t> cnt(R + 1, 0);
    for (int64_t e = 0; e < E; ++e) cnt[in_rows[e] + 1]++;
    for (int64_t i = 0; i < R; ++i) cnt[i + 1] += cnt[i];
    for (int64_t e = 0; e < E; ++e) EL[cnt[in_rows[e]]++] = (int32_t)e;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t e = 0; e < E; ++e) cnt[out_rows[e] + 1]++;
    for (int64_t i = 0; i < R; ++i) cnt[i + 1] += cnt[i];
    for (int64_t e = 0; e < E; ++e) ER[cnt[out_rows[e]]++] = (int32_t)e;
  }

  std::vector<int64_t> bounds = {0, E}, next_bounds;
  int levels = 0;
  while ((1 << levels) < k) ++levels;

  for (int level = 0; level < levels; ++level) {
    // pairing successors (independent-access passes — MLP-friendly):
    //   succL[e] = the L-pair partner of e; succR likewise;
    //   g = succR ∘ succL, whose orbits are ALTERNATE edges of each pairing
    //   cycle — walking g touches E/2 edges with ONE dependent load each.
    for (int64_t i = 0; i < E; ++i) succL[EL[i]] = EL[i ^ 1];
    for (int64_t i = 0; i < E; ++i) succR[ER[i]] = ER[i ^ 1];
    for (int64_t e = 0; e < E; ++e) g[e] = succR[succL[e]];
    std::memset(visited.data(), 0, E);
    std::memset(bits.data(), 1, E);
    // orbit walk: one dependent load per TWO edges (g hops even positions)
    for (int64_t s0 = 0; s0 < E; ++s0) {
      if (visited[s0]) continue;
      int32_t e = (int32_t)s0;
      do {
        visited[e] = 1;
        bits[e] = 0;
        visited[succL[e]] = 1;  // the odd-position partner keeps bit 1
        e = g[e];
      } while (!visited[e]);
    }
    // apply this level's bit; segment-local stable partition keeps every
    // class contiguous (and every per-vertex run even-aligned)
    next_bounds.clear();
    int64_t outL = 0;
    for (size_t c = 0; c + 1 < bounds.size(); ++c) {
      const int64_t lo = bounds[c], hi = bounds[c + 1];
      next_bounds.push_back(outL);
      for (int64_t i = lo; i < hi; ++i)
        if (!bits[EL[i]]) EL2[outL++] = EL[i];
      next_bounds.push_back(outL);
      for (int64_t i = lo; i < hi; ++i)
        if (bits[EL[i]]) {
          colors[EL[i]] |= (1 << level);
          EL2[outL++] = EL[i];
        }
    }
    next_bounds.push_back(outL);
    int64_t outR = 0;
    for (size_t c = 0; c + 1 < bounds.size(); ++c) {
      const int64_t lo = bounds[c], hi = bounds[c + 1];
      for (int64_t i = lo; i < hi; ++i)
        if (!bits[ER[i]]) ER2[outR++] = ER[i];
      for (int64_t i = lo; i < hi; ++i)
        if (bits[ER[i]]) ER2[outR++] = ER[i];
    }
    EL.swap(EL2);
    ER.swap(ER2);
    bounds.swap(next_bounds);
  }
  return 0;
}

}  // extern "C"


extern "C" {

// Latency-hidden 128-edge-coloring: euler_color2's orbit walk with K
// INTERLEAVED walkers.
//
// euler_color2's single orbit walk is a serial dependent-load chain
// (`e = g[e]`): E/2 random DRAM reads per split level whose latency cannot
// overlap — on a 1-core host it is the whole plan-build wall.  Here K
// walkers each chase their own chain; the out-of-order core overlaps their
// cache misses (memory-level parallelism), turning the walk from
// latency-bound into throughput-bound.
//
// Correctness: each pairing cycle consists of TWO g-orbits (even and odd
// positions, images of each other under succL).  A walker claims orbit
// edges with local bit 0 and their succL partners with bit 1, tagging both
// with its segment id.  Walks end at already-claimed edges; the required
// color there yields a parity CONSTRAINT between the two segments
// (flip[a] ^ flip[b] = rel).  Partner claims that collide likewise add
// constraints.  A union-find with parity resolves all flips (even cycles
// guarantee consistency); one linear pass applies bit ^ flip[seg].
int gbtpu_euler_color3(const int32_t *in_rows, const int32_t *out_rows,
                       int64_t E, int64_t R, int32_t k, int32_t *colors) {
  if (k <= 0 || (k & (k - 1)) != 0) return 1;
  std::memset(colors, 0, sizeof(int32_t) * E);
  if (E == 0 || k == 1) return 0;

  constexpr int K = 32;  // concurrent chains (MLP depth target)

  std::vector<int32_t> EL(E), ER(E), EL2(E), ER2(E);
  std::vector<int32_t> succL(E), succR(E);
  std::vector<int32_t> claim(E);
  std::vector<uint8_t> bits(E);

  {
    std::vector<int64_t> cnt(R + 1, 0);
    for (int64_t e = 0; e < E; ++e) cnt[in_rows[e] + 1]++;
    for (int64_t i = 0; i < R; ++i) cnt[i + 1] += cnt[i];
    for (int64_t e = 0; e < E; ++e) EL[cnt[in_rows[e]]++] = (int32_t)e;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t e = 0; e < E; ++e) cnt[out_rows[e] + 1]++;
    for (int64_t i = 0; i < R; ++i) cnt[i + 1] += cnt[i];
    for (int64_t e = 0; e < E; ++e) ER[cnt[out_rows[e]]++] = (int32_t)e;
  }

  std::vector<int64_t> bounds = {0, E}, next_bounds;
  int levels = 0;
  while ((1 << levels) < k) ++levels;

  // union-find with parity over segments
  std::vector<int32_t> uf_parent;
  std::vector<int8_t> uf_rel;  // parity to parent
  struct Constraint {
    int32_t a, b;
    uint8_t rel;
  };
  std::vector<Constraint> cons;

  auto uf_find = [&](int32_t x, uint8_t &par) {
    uint8_t p = 0;
    int32_t root = x;
    while (uf_parent[root] != root) {
      p ^= (uint8_t)uf_rel[root];
      root = uf_parent[root];
    }
    // path compression
    int32_t cur = x;
    uint8_t cp = p;
    while (uf_parent[cur] != root) {
      const int32_t nxt = uf_parent[cur];
      const uint8_t step = (uint8_t)uf_rel[cur];
      uf_parent[cur] = root;
      uf_rel[cur] = (int8_t)cp;
      cp ^= step;
      cur = nxt;
    }
    par = p;
    return root;
  };

  for (int level = 0; level < levels; ++level) {
    for (int64_t i = 0; i < E; ++i) succL[EL[i]] = EL[i ^ 1];
    for (int64_t i = 0; i < E; ++i) succR[ER[i]] = ER[i ^ 1];
    std::memset(claim.data(), 0xFF, sizeof(int32_t) * E);  // -1
    cons.clear();

    int32_t cur[K];
    int32_t seg[K];
    bool fresh[K];  // no claims yet in this segment (never continue from one)
    int32_t nseg = 0;
    int64_t scan = 0;
    int active = 0;
    // prime walkers
    for (int w = 0; w < K; ++w) {
      while (scan < E && claim[scan] >= 0) ++scan;
      if (scan >= E) break;
      cur[w] = (int32_t)scan++;
      seg[w] = nseg++;
      fresh[w] = true;
      ++active;
    }
    const int primed = active;
    while (active > 0) {
      for (int w = 0; w < primed; ++w) {
        int32_t e = cur[w];
        if (e < 0) continue;
        const int32_t c = claim[e];
        if (c >= 0) {
          // arrival wanted color 0 here: parity constraint to c's segment
          if (!fresh[w]) cons.push_back({seg[w], c >> 1, (uint8_t)(c & 1)});
          if (!fresh[w] && (c & 1)) {
            // partner-claimed only — nobody else walks THIS orbit past e;
            // keep going (terminates at the first orbit-claimed edge, our
            // own earliest claim at worst)
            const int32_t nxt = succR[succL[e]];
            cur[w] = nxt;
            __builtin_prefetch(&claim[nxt]);
            __builtin_prefetch(&succL[nxt]);
            continue;
          }
          // orbit-claimed (its walker covers the rest) or a raced fresh
          // start: take a new start
          while (scan < E && claim[scan] >= 0) ++scan;
          if (scan >= E) {
            cur[w] = -1;
            --active;
            continue;
          }
          cur[w] = (int32_t)scan++;
          seg[w] = nseg++;
          fresh[w] = true;
          continue;
        }
        claim[e] = seg[w] << 1;
        fresh[w] = false;
        const int32_t p = succL[e];
        const int32_t pc = claim[p];
        if (pc >= 0) {
          // partner already claimed: we need it colored 1
          cons.push_back({seg[w], pc >> 1, (uint8_t)((pc & 1) ^ 1)});
        } else {
          claim[p] = (seg[w] << 1) | 1;
        }
        const int32_t nxt = succR[p];
        cur[w] = nxt;
        __builtin_prefetch(&claim[nxt]);
        __builtin_prefetch(&succL[nxt]);
      }
    }

    // resolve segment flips
    uf_parent.resize(nseg);
    uf_rel.assign(nseg, 0);
    for (int32_t s = 0; s < nseg; ++s) uf_parent[s] = s;
    for (const Constraint &c : cons) {
      uint8_t pa, pb;
      const int32_t ra = uf_find(c.a, pa);
      const int32_t rb = uf_find(c.b, pb);
      if (ra == rb) {
        if ((uint8_t)(pa ^ pb) != c.rel) return 2;  // inconsistent (bug)
        continue;
      }
      uf_parent[ra] = rb;
      uf_rel[ra] = (int8_t)(pa ^ pb ^ c.rel);
    }
    std::vector<uint8_t> flip(nseg);
    for (int32_t s = 0; s < nseg; ++s) {
      uint8_t p;
      uf_find(s, p);
      flip[s] = p;
    }
    for (int64_t e = 0; e < E; ++e) {
      const int32_t c = claim[e];
      bits[e] = (uint8_t)((c & 1) ^ flip[c >> 1]);
    }

    next_bounds.clear();
    int64_t outL = 0;
    for (size_t c = 0; c + 1 < bounds.size(); ++c) {
      const int64_t lo = bounds[c], hi = bounds[c + 1];
      next_bounds.push_back(outL);
      for (int64_t i = lo; i < hi; ++i)
        if (!bits[EL[i]]) EL2[outL++] = EL[i];
      next_bounds.push_back(outL);
      for (int64_t i = lo; i < hi; ++i)
        if (bits[EL[i]]) {
          colors[EL[i]] |= (1 << level);
          EL2[outL++] = EL[i];
        }
    }
    next_bounds.push_back(outL);
    int64_t outR = 0;
    for (size_t c = 0; c + 1 < bounds.size(); ++c) {
      const int64_t lo = bounds[c], hi = bounds[c + 1];
      for (int64_t i = lo; i < hi; ++i)
        if (!bits[ER[i]]) ER2[outR++] = ER[i];
      for (int64_t i = lo; i < hi; ++i)
        if (bits[ER[i]]) ER2[outR++] = ER[i];
    }
    EL.swap(EL2);
    ER.swap(ER2);
    bounds.swap(next_bounds);
  }
  return 0;
}

}  // extern "C"


extern "C" {

// Position-space coloring: euler_color3's walk with the class state kept in
// LEFT-POSITION space so every class occupies a CONTIGUOUS window in both
// orders.  Deep split levels then touch only window-sized memory
// (cache-resident), where euler_color3's edge-id-indexed arrays stay
// full-range random at every level.
//
//   P[i]    = right position of the edge at left position i
//   Pinv[j] = left position of the edge at right position j
//   L-pair of left position i is i^1; R-pair of right position j is j^1
//   orbit step from left position i:  i -> Pinv[P[i ^ 1] ^ 1]
//
// After each split the stable partitions renumber positions within the
// class, so P/Pinv/orig/colpos are maintained by sequential passes with
// window-local random reads only.  Colors accumulate in position space and
// scatter to edge ids once at the end.
int gbtpu_euler_color4(const int32_t *in_rows, const int32_t *out_rows,
                       int64_t E, int64_t R, int32_t k, int32_t *colors) {
  if (k <= 0 || (k & (k - 1)) != 0) return 1;
  std::memset(colors, 0, sizeof(int32_t) * E);
  if (E == 0 || k == 1) return 0;

  constexpr int K = 32;

  std::vector<int32_t> P(E), Pinv(E), P2(E), Pinv2(E);
  std::vector<int32_t> orig(E), orig2(E);
  std::vector<int32_t> colpos(E, 0), colpos2(E);
  std::vector<int32_t> claim(E);
  std::vector<int32_t> nposR(E);
  std::vector<uint8_t> bitL(E), bitR(E);

  {
    std::vector<int64_t> cnt(R + 1, 0);
    std::vector<int32_t> ER(E);
    for (int64_t e = 0; e < E; ++e) cnt[in_rows[e] + 1]++;
    for (int64_t i = 0; i < R; ++i) cnt[i + 1] += cnt[i];
    for (int64_t e = 0; e < E; ++e) orig[cnt[in_rows[e]]++] = (int32_t)e;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t e = 0; e < E; ++e) cnt[out_rows[e] + 1]++;
    for (int64_t i = 0; i < R; ++i) cnt[i + 1] += cnt[i];
    for (int64_t e = 0; e < E; ++e) ER[cnt[out_rows[e]]++] = (int32_t)e;
    // posR[edge] -> P[left pos] (reuse nposR as scratch posR)
    for (int64_t j = 0; j < E; ++j) nposR[ER[j]] = (int32_t)j;
    for (int64_t i = 0; i < E; ++i) P[i] = nposR[orig[i]];
    for (int64_t i = 0; i < E; ++i) Pinv[P[i]] = (int32_t)i;
  }

  std::vector<int64_t> bounds = {0, E}, next_bounds;
  int levels = 0;
  while ((1 << levels) < k) ++levels;

  std::vector<int32_t> uf_parent;
  std::vector<int8_t> uf_rel;
  struct Cons {
    int32_t a, b;
    uint8_t rel;
  };
  std::vector<Cons> cons;

  auto uf_find = [&](int32_t x, uint8_t &par) {
    uint8_t p = 0;
    int32_t root = x;
    while (uf_parent[root] != root) {
      p ^= (uint8_t)uf_rel[root];
      root = uf_parent[root];
    }
    int32_t cur = x;
    uint8_t cp = p;
    while (uf_parent[cur] != root) {
      const int32_t nxt = uf_parent[cur];
      const uint8_t step = (uint8_t)uf_rel[cur];
      uf_parent[cur] = root;
      uf_rel[cur] = (int8_t)cp;
      cp ^= step;
      cur = nxt;
    }
    par = p;
    return root;
  };

  std::vector<uint8_t> flip;
  for (int level = 0; level < levels; ++level) {
    // ---- walk every class with K interleaved walkers --------------------
    std::memset(claim.data(), 0xFF, sizeof(int32_t) * E);
    cons.clear();
    int32_t nseg = 0;
    for (size_t c = 0; c + 1 < bounds.size(); ++c) {
      const int64_t lo = bounds[c], hi = bounds[c + 1];
      int32_t cur[K];
      int32_t seg[K];
      bool fresh[K];
      int64_t scan = lo;
      int active = 0;
      for (int w = 0; w < K; ++w) {
        while (scan < hi && claim[scan] >= 0) ++scan;
        if (scan >= hi) break;
        cur[w] = (int32_t)scan++;
        seg[w] = nseg++;
        fresh[w] = true;
        ++active;
      }
      const int primed = active;
      while (active > 0) {
        for (int w = 0; w < primed; ++w) {
          int32_t i = cur[w];
          if (i < 0) continue;
          const int32_t cl = claim[i];
          if (cl >= 0) {
            if (!fresh[w]) cons.push_back({seg[w], cl >> 1, (uint8_t)(cl & 1)});
            if (!fresh[w] && (cl & 1)) {
              const int32_t nxt = Pinv[P[i ^ 1] ^ 1];
              cur[w] = nxt;
              __builtin_prefetch(&claim[nxt]);
              __builtin_prefetch(&P[nxt ^ 1]);
              continue;
            }
            while (scan < hi && claim[scan] >= 0) ++scan;
            if (scan >= hi) {
              cur[w] = -1;
              --active;
              continue;
            }
            cur[w] = (int32_t)scan++;
            seg[w] = nseg++;
            fresh[w] = true;
            continue;
          }
          claim[i] = seg[w] << 1;
          fresh[w] = false;
          const int32_t p = i ^ 1;  // L-pair partner (same cache line)
          const int32_t pc = claim[p];
          if (pc >= 0) {
            cons.push_back({seg[w], pc >> 1, (uint8_t)((pc & 1) ^ 1)});
          } else {
            claim[p] = (seg[w] << 1) | 1;
          }
          const int32_t nxt = Pinv[P[p] ^ 1];
          cur[w] = nxt;
          __builtin_prefetch(&claim[nxt]);
          __builtin_prefetch(&P[nxt ^ 1]);
        }
      }
    }

    // ---- resolve segment flips ------------------------------------------
    uf_parent.resize(nseg);
    uf_rel.assign(nseg, 0);
    for (int32_t s = 0; s < nseg; ++s) uf_parent[s] = s;
    for (const Cons &c : cons) {
      uint8_t pa, pb;
      const int32_t ra = uf_find(c.a, pa);
      const int32_t rb = uf_find(c.b, pb);
      if (ra == rb) {
        if ((uint8_t)(pa ^ pb) != c.rel) return 2;
        continue;
      }
      uf_parent[ra] = rb;
      uf_rel[ra] = (int8_t)(pa ^ pb ^ c.rel);
    }
    flip.resize(nseg);
    for (int32_t s = 0; s < nseg; ++s) {
      uint8_t p;
      uf_find(s, p);
      flip[s] = p;
    }
    for (int64_t i = 0; i < E; ++i) {
      const int32_t cl = claim[i];
      bitL[i] = (uint8_t)((cl & 1) ^ flip[cl >> 1]);
    }
    // right-position bits (window-local random read)
    for (int64_t j = 0; j < E; ++j) bitR[j] = bitL[Pinv[j]];

    // ---- stable partitions + map maintenance ----------------------------
    next_bounds.clear();
    for (size_t c = 0; c + 1 < bounds.size(); ++c) {
      const int64_t lo = bounds[c], hi = bounds[c + 1];
      // new right positions within this class
      int64_t r0 = lo;
      for (int64_t j = lo; j < hi; ++j)
        if (!bitR[j]) nposR[j] = (int32_t)r0++;
      int64_t r1 = r0;
      for (int64_t j = lo; j < hi; ++j)
        if (bitR[j]) nposR[j] = (int32_t)r1++;
      // left partition, emitting P2/orig2/colpos2 in new order
      int64_t o0 = lo, o1 = 0;
      // count zeros to find the split point
      int64_t zeros = 0;
      for (int64_t i = lo; i < hi; ++i) zeros += (bitL[i] == 0);
      o1 = lo + zeros;
      next_bounds.push_back(lo);
      next_bounds.push_back(o1);
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t d = bitL[i] ? o1++ : o0++;
        P2[d] = nposR[P[i]];
        orig2[d] = orig[i];
        colpos2[d] = colpos[i] | ((int32_t)bitL[i] << level);
      }
      for (int64_t i = lo; i < hi; ++i) Pinv2[P2[i]] = (int32_t)i;
    }
    next_bounds.push_back(E);
    P.swap(P2);
    Pinv.swap(Pinv2);
    orig.swap(orig2);
    colpos.swap(colpos2);
    bounds.swap(next_bounds);
  }

  for (int64_t i = 0; i < E; ++i) colors[orig[i]] = colpos[i];
  return 0;
}

}  // extern "C"

namespace {

// 128x128 tile transpose between strided slabs (the T-stage digit swap).
// in slot ((qq*128 + a)*M + mm)*128 + b  ->  out slot ((qq*128 + b)*M + mm)*128 + a
void t_stage_transpose(const int32_t *in, int32_t *out, int64_t n, int64_t M) {
  const int64_t q = n / (128 * M * 128);
  const int64_t rowstride = M * 128;
  constexpr int64_t B = 16;  // tile edge (16x16 int32 tiles = 2 KB)
  for (int64_t qq = 0; qq < q; ++qq) {
    for (int64_t mm = 0; mm < M; ++mm) {
      const int64_t base = (qq * 128 * M + mm) * 128;
      for (int64_t a0 = 0; a0 < 128; a0 += B) {
        for (int64_t b0 = 0; b0 < 128; b0 += B) {
          for (int64_t a = a0; a < a0 + B; ++a) {
            const int32_t *src = in + base + a * rowstride + b0;
            int32_t *dst = out + base + b0 * rowstride + a;
            for (int64_t b = 0; b < B; ++b) dst[b * rowstride] = src[b];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Fused Benes/Clos network builder: the whole per-level stage loop of
// graphblas_tpu/ops/permute.py::build_permutation_plan in one native call.
// The numpy formulation pays ~8 full-array passes per level (t[elem]
// gathers, separate S applies, digit-swap transposes, routing-table
// scatters); here each level is one fused pass per side plus the coloring.
//
// perm: target permutation (out[p] = in[perm[p]]), n = m * 128^L * 128.
// s_out: (2L+2) int8 tables of r*128 each — forward S for lvl 0..L, then
//        backward S_post for lvl L..0 (the stage order around them is
//        reconstructed by the Python wrapper).
// rsel_out: r*128 int32 — the m-way row-select table (src_top), laid out
//        (m, 128^L, 128).
// Returns 0 on success, 3 on a routing collision (invalid coloring).
int gbtpu_build_network(const int32_t *perm, int64_t n, int8_t *s_out,
                        int32_t *rsel_out) {
  // shape params
  int64_t r = n / 128;
  int L = 0;
  int64_t m = r;
  while (m > 128) {
    if (m % 128) return 1;
    m /= 128;
    L += 1;
  }

  std::vector<int32_t> t(n), elem(n), buf(n), colors(n), out_row(n);
  for (int64_t p = 0; p < n; ++p) t[perm[p]] = (int32_t)p;
  for (int64_t s = 0; s < n; ++s) elem[s] = (int32_t)s;

  // scratch for the strided (lvl > 0) group colorings
  std::vector<int32_t> in_local, out_g, colors_g;

  int8_t *s_tab = s_out;
  for (int lvl = 0; lvl <= L; ++lvl) {
    const int64_t stride = (int64_t)1 << (7 * lvl);
    const int shift = 7 * (lvl + 1);
    // te/out_row pass (elem sequential, t random gather)
    for (int64_t s = 0; s < n; ++s) {
      const int32_t te = t[elem[s]];
      out_row[s] = (int32_t)(((int64_t)te >> shift) * stride + ((s >> 7) % stride));
    }
    if (stride == 1) {
      // full-size coloring; in_rows is the slot-row pattern
      if ((int64_t)in_local.size() < n) in_local.resize(n);
      for (int64_t s = 0; s < n; ++s) in_local[s] = (int32_t)(s >> 7);
      const int rc = gbtpu_euler_color3(in_local.data(), out_row.data(), n, r,
                                        128, colors.data());
      if (rc != 0) return rc;
    } else {
      // stride groups are independent colorings of r/stride rows each
      const int64_t rs = r / stride;
      const int64_t seglen = rs * 128;
      in_local.resize(seglen);
      for (int64_t i = 0; i < seglen; ++i) in_local[i] = (int32_t)(i >> 7);
      out_g.resize(n);
      colors_g.resize(n);
      // regroup: group g takes rows (g, g+stride, g+2*stride, ...)
      for (int64_t g = 0; g < stride; ++g) {
        int32_t *dst = out_g.data() + g * seglen;
        for (int64_t i = 0; i < rs; ++i) {
          const int64_t srow = i * stride + g;
          const int32_t *src = out_row.data() + srow * 128;
          for (int64_t l = 0; l < 128; ++l) dst[i * 128 + l] = (int32_t)(src[l] / stride);
        }
        const int rc = gbtpu_euler_color2(in_local.data(), dst, seglen, rs, 128,
                                          colors_g.data() + g * seglen);
        if (rc != 0) return rc;
      }
      // ungroup colors back to slot order
      for (int64_t g = 0; g < stride; ++g) {
        const int32_t *src = colors_g.data() + g * seglen;
        for (int64_t i = 0; i < rs; ++i) {
          const int64_t srow = i * stride + g;
          std::memcpy(colors.data() + srow * 128, src + i * 128,
                      128 * sizeof(int32_t));
        }
      }
    }
    // fused S-table build + S apply: elem2[row*128 + color] = elem[s]
    std::memset(s_tab, 0xFF, r * 128);
    for (int64_t s = 0; s < n; ++s) {
      const int64_t d = ((s >> 7) << 7) + colors[s];
      if (s_tab[d] != (int8_t)-1) return 3;
      s_tab[d] = (int8_t)(s & 127);
      buf[d] = elem[s];
    }
    s_tab += r * 128;
    elem.swap(buf);

    if (lvl < L) {
      const int64_t M = (int64_t)1 << (7 * lvl);
      t_stage_transpose(elem.data(), buf.data(), n, M);
      elem.swap(buf);
    } else {
      // RSEL: dest_row gets row s>>7's lane (same lane), table = src row / stride
      std::memset(rsel_out, 0xFF, r * 128 * sizeof(int32_t));
      for (int64_t s = 0; s < n; ++s) {
        const int32_t te = t[elem[s]];
        const int64_t dest_row =
            ((int64_t)te >> shift) * stride + ((s >> 7) % stride);
        const int64_t d = (dest_row << 7) + (s & 127);
        if (rsel_out[d] != -1) return 3;
        rsel_out[d] = (int32_t)((s >> 7) / stride);
        buf[d] = elem[s];
      }
      elem.swap(buf);
    }
  }

  // backward: S_post(L), then (T, S_post) down to lvl 0
  for (int lvl = L; lvl >= 0; --lvl) {
    if (lvl < L) {
      const int64_t M = (int64_t)1 << (7 * lvl);
      t_stage_transpose(elem.data(), buf.data(), n, M);
      elem.swap(buf);
    }
    const int shift = 7 * lvl;
    std::memset(s_tab, 0xFF, r * 128);
    for (int64_t s = 0; s < n; ++s) {
      const int32_t req_lane = (int32_t)(((int64_t)t[elem[s]] >> shift) & 127);
      const int64_t d = ((s >> 7) << 7) + req_lane;
      if (s_tab[d] != (int8_t)-1) return 3;
      s_tab[d] = (int8_t)(s & 127);
      buf[d] = elem[s];
    }
    s_tab += r * 128;
    elem.swap(buf);
  }

  // final check: the network must reproduce the permutation
  for (int64_t s = 0; s < n; ++s)
    if (elem[s] != perm[s]) return 4;
  return 0;
}

}  // extern "C"


extern "C" {

// Batched coloring of many INDEPENDENT k-regular bipartite subproblems
// (the stride decomposition of level>0 S-stage routings): one call, one
// loop in C — the per-call Python/ctypes overhead dominated when levels
// decomposed into tens of thousands of tiny groups.
// Every group g covers edges [g*seglen, (g+1)*seglen) with rows in [0, Rs).
// in_rows is the same repeating pattern for every group (slot/128).
int gbtpu_euler_color_batched(const int32_t *in_rows_local,
                              const int32_t *out_rows, int64_t seglen,
                              int64_t n_groups, int64_t Rs, int32_t k,
                              int32_t *colors) {
  for (int64_t g = 0; g < n_groups; ++g) {
    const int rc = gbtpu_euler_color2(in_rows_local, out_rows + g * seglen,
                                      seglen, Rs, k, colors + g * seglen);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
