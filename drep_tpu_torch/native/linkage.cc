// Sparse average-linkage (UPGMA) over a retained edge graph — the native
// fast path for ops/linkage.py::sparse_average_linkage (the streaming
// primary's clustering at the 100k-genome scale, where the Python
// dict+heapq formulation is host-bound: dict-of-dicts adjacency costs
// ~100+ bytes/edge and every heap op boxes a tuple).
//
// SEMANTIC CONTRACT: this is a bit-exact replica of the Python
// implementation, not an alternative. The heap orders entries by the
// full (avg, a, b, s, c) tuple exactly as Python's heapq orders its
// tuples; bounds are computed with the same operation order
// ((s + (total - c) * keep) / total, all double); duplicate input edges
// collapse to their minimum with first-writer-wins on ties, in input
// order. With a strict total order over distinct entries the pop
// sequence — and therefore every accepted merge and the final
// partition — is uniquely determined, so the two implementations can be
// equality-tested label-for-label (tests/test_torch_streaming.py).
//
// Unobserved cross pairs enter averages at the retention bound `keep`
// (one-sided exactness analysis in the Python docstring); merges that
// averaged over unobserved pairs are counted into *approx_merges_out.

#include <cstdint>
#include <cstdlib>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct Stat {
  double s;
  int64_t c;
};

struct Entry {
  double avg;
  int64_t a, b;
  double s;
  int64_t c;
};

// Python tuple order: (avg, a, b, s, c) ascending; priority_queue pops the
// LARGEST, so the comparator says "x is worse (later) than y".
struct Later {
  bool operator()(const Entry& x, const Entry& y) const {
    if (x.avg != y.avg) return x.avg > y.avg;
    if (x.a != y.a) return x.a > y.a;
    if (x.b != y.b) return x.b > y.b;
    if (x.s != y.s) return x.s > y.s;
    return x.c > y.c;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. labels_out[n]: arbitrary cluster ids (the caller
// renumbers by first appearance, same as the Python path).
int drep_sparse_upgma(int64_t n, int64_t n_edges, const int64_t* ii,
                      const int64_t* jj, const double* dd, double cutoff,
                      double keep, int64_t* labels_out,
                      int64_t* approx_merges_out) {
  if (n <= 0) {
    *approx_merges_out = 0;
    return 0;
  }
  const int64_t max_nodes = 2 * n;  // n leaves + at most n-1 merged ids
  std::vector<std::unordered_map<int64_t, Stat>> nbr(
      static_cast<size_t>(max_nodes));
  std::vector<int64_t> size(static_cast<size_t>(max_nodes), 0);
  std::vector<int64_t> left(static_cast<size_t>(max_nodes), -1);
  std::vector<int64_t> right(static_cast<size_t>(max_nodes), -1);
  std::vector<char> alive(static_cast<size_t>(max_nodes), 0);
  for (int64_t i = 0; i < n; ++i) {
    size[i] = 1;
    alive[i] = 1;
  }

  // duplicate edges collapse to their min, first-writer-wins on ties
  // (python: `if cur is None or d < cur[0]`), in input order. An
  // out-of-range index is a caller bug — reported loudly (rc -2, the
  // wrapper raises), matching the Python path's KeyError, never a
  // silently wrong partition.
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t a = ii[e], b = jj[e];
    if (a < 0 || b < 0 || a >= n || b >= n) return -2;
    if (a == b) continue;
    const double d = dd[e];
    auto it = nbr[a].find(b);
    if (it == nbr[a].end() || d < it->second.s) {
      nbr[a][b] = Stat{d, 1};
      nbr[b][a] = Stat{d, 1};
    }
  }

  std::vector<Entry> initial;
  for (int64_t a = 0; a < n; ++a) {
    for (const auto& kv : nbr[a]) {
      if (a < kv.first) {
        initial.push_back(Entry{kv.second.s, a, kv.first, kv.second.s,
                                kv.second.c});
      }
    }
  }
  std::priority_queue<Entry, std::vector<Entry>, Later> heap(
      Later(), std::move(initial));

  int64_t next_id = n;
  int64_t approx = 0;
  while (!heap.empty()) {
    const Entry top = heap.top();
    if (top.avg > cutoff) break;  // heap min = global min over candidates
    heap.pop();
    const int64_t a = top.a, b = top.b;
    if (!alive[a] || !alive[b]) continue;
    auto ab = nbr[a].find(b);
    // stale entry: the pair's stats changed since this entry was pushed
    if (ab == nbr[a].end() || ab->second.s != top.s || ab->second.c != top.c)
      continue;
    if (top.c < size[a] * size[b]) ++approx;
    const int64_t cid = next_id++;
    std::unordered_map<int64_t, Stat> merged;
    // a's contribution accumulates before b's — same float-add order as
    // the python loop `for src in (a, b)`
    for (const int64_t src : {a, b}) {
      for (const auto& kv : nbr[src]) {
        const int64_t x = kv.first;
        if (x == a || x == b) continue;
        nbr[x].erase(src);
        auto m = merged.find(x);
        if (m == merged.end()) {
          merged[x] = kv.second;
        } else {
          m->second.s += kv.second.s;
          m->second.c += kv.second.c;
        }
      }
    }
    nbr[a].clear();
    nbr[b].clear();
    alive[a] = 0;
    alive[b] = 0;
    alive[cid] = 1;
    size[cid] = size[a] + size[b];
    left[cid] = a;
    right[cid] = b;
    nbr[cid] = std::move(merged);
    for (const auto& kv : nbr[cid]) {
      const int64_t x = kv.first;
      nbr[x][cid] = kv.second;
      const int64_t tot = size[cid] * size[x];
      const double avg =
          (kv.second.s + static_cast<double>(tot - kv.second.c) * keep) /
          static_cast<double>(tot);
      heap.push(Entry{avg, cid, x, kv.second.s, kv.second.c});
    }
  }

  // resolve labels: iterative DFS from every alive root over the merge tree
  std::vector<int64_t> stack;
  for (int64_t cid = 0; cid < next_id; ++cid) {
    if (!alive[cid]) continue;
    stack.push_back(cid);
    while (!stack.empty()) {
      const int64_t node = stack.back();
      stack.pop_back();
      if (node < n) {
        labels_out[node] = cid;
      } else {
        stack.push_back(left[node]);
        stack.push_back(right[node]);
      }
    }
  }
  *approx_merges_out = approx;
  return 0;
}

}  // extern "C"
