// Host mesh/topology helper of multigrid_tpu_torch (a copy of the JAX
// package's native/meshgen.cpp, so that the port builds its own library).
//
// Global dof identification across multiblock meshes (coordinate hashing)
// and cell->node index tables for one structured block: the setup-time
// role deal.II + p4est play for the reference.  Plain C ABI, loaded with
// ctypes by mesh/native.py, which builds it with g++ at first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Key3 {
  int64_t a, b, c;
  bool operator==(const Key3 &o) const { return a == o.a && b == o.b && c == o.c; }
};

struct Key3Hash {
  size_t operator()(const Key3 &k) const {
    // splitmix-style mixing
    uint64_t h = 0x9e3779b97f4a7c15ull;
    for (uint64_t v : {(uint64_t)k.a, (uint64_t)k.b, (uint64_t)k.c}) {
      v ^= v >> 30; v *= 0xbf58476d1ce4e5b9ull;
      v ^= v >> 27; v *= 0x94d049bb133111ebull;
      v ^= v >> 31;
      h ^= v + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    }
    return (size_t)h;
  }
};

}  // namespace

extern "C" {

// Deduplicate points by rounded coordinates.
//   coords: [n, dim] doubles (dim <= 3), tol: rounding quantum
//   inverse: out [n] int64 (unique id per point)
// Returns the number of unique points; ids are assigned in first-seen order.
int64_t mg_unique_nodes(const double *coords, int64_t n, int32_t dim,
                        double tol, int64_t *inverse) {
  std::unordered_map<Key3, int64_t, Key3Hash> table;
  table.reserve((size_t)n * 2);
  const double inv = 1.0 / tol;
  int64_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    Key3 k{0, 0, 0};
    const double *p = coords + (size_t)i * dim;
    k.a = (int64_t)std::llround(p[0] * inv);
    if (dim > 1) k.b = (int64_t)std::llround(p[1] * inv);
    if (dim > 2) k.c = (int64_t)std::llround(p[2] * inv);
    auto it = table.find(k);
    if (it == table.end()) {
      table.emplace(k, next);
      inverse[i] = next++;
    } else {
      inverse[i] = it->second;
    }
  }
  return next;
}

// Cell -> node index table for one structured block of an FE_Q(p) grid.
//   cells: [dim] cell counts, p: degree; node grid has cells[d]*p+1 nodes
//   per axis in lexicographic (axis-0 slowest) order.
//   out: [prod(cells), (p+1)^dim] int64 local node indices.
void mg_block_cell_nodes(const int64_t *cells, int32_t dim, int32_t p,
                         int64_t *out) {
  int64_t nn[3] = {1, 1, 1};
  for (int d = 0; d < dim; ++d) nn[d] = cells[d] * p + 1;
  int64_t stride[3] = {1, 1, 1};
  for (int d = dim - 2; d >= 0; --d) stride[d] = stride[d + 1] * nn[d + 1];
  const int n = p + 1;
  int64_t n_loc = 1;
  for (int d = 0; d < dim; ++d) n_loc *= n;

  int64_t c[3] = {0, 0, 0};
  int64_t n_cells = 1;
  for (int d = 0; d < dim; ++d) n_cells *= cells[d];
  for (int64_t ci = 0; ci < n_cells; ++ci) {
    // decode lexicographic cell index (axis 0 slowest)
    int64_t rem = ci;
    for (int d = dim - 1; d >= 0; --d) {
      c[d] = rem % cells[d];
      rem /= cells[d];
    }
    int64_t *row = out + ci * n_loc;
    int64_t l[3] = {0, 0, 0};
    for (int64_t li = 0; li < n_loc; ++li) {
      int64_t reml = li;
      for (int d = dim - 1; d >= 0; --d) {
        l[d] = reml % n;
        reml /= n;
      }
      int64_t g = 0;
      for (int d = 0; d < dim; ++d) g += (c[d] * p + l[d]) * stride[d];
      row[li] = g;
    }
  }
}

}  // extern "C"
