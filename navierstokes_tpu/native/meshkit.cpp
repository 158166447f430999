// meshkit — native host-side mesh preprocessing kernels.
//
// The framework's "runtime around the compute path": the O(n log n)
// topology passes that stand between a raw mesh and the device arrays
// (unique-edge extraction for P2 DoF numbering, boundary-facet extraction,
// scatter-plan sorting).  The reference delegates these to deal.II's C++
// internals (DoFHandler/GridTools, src/NavierStokes.cpp:61-92); here they
// are standalone C++ with a C ABI consumed through ctypes
// (navierstokes_tpu/native/__init__.py), with a numpy fallback kept as the
// reference implementation (fem/spaces.py, mesh/geometry.py).
//
// Build: g++ -O3 -march=native -shared -fPIC meshkit.cpp -o libmeshkit.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// unique_edges: given cells (n_cells x k) vertex ids and the local edge
// table (n_edges_local x 2), emit globally unique (lo,hi) vertex pairs and
// the per-cell local-edge -> global-edge map.
//
// Two-phase API: phase 1 (count) returns the number of unique edges;
// phase 2 fills caller-allocated outputs.  A handle carries state between
// phases.
// ---------------------------------------------------------------------------

struct EdgeWork {
    std::vector<int64_t> keys;     // encoded lo*n_pts+hi per (cell, ledge)
    std::vector<int64_t> uniq;     // sorted unique keys
    int64_t n_pts = 0;
};

void* edges_begin(const int32_t* cells, int64_t n_cells, int32_t k,
                  const int32_t* ledges, int32_t n_ledges, int64_t n_pts) {
    auto* w = new EdgeWork();
    w->n_pts = n_pts;
    w->keys.resize(static_cast<size_t>(n_cells) * n_ledges);
    for (int64_t c = 0; c < n_cells; ++c) {
        const int32_t* row = cells + c * k;
        for (int32_t e = 0; e < n_ledges; ++e) {
            int64_t a = row[ledges[2 * e]];
            int64_t b = row[ledges[2 * e + 1]];
            if (a > b) std::swap(a, b);
            w->keys[c * n_ledges + e] = a * n_pts + b;
        }
    }
    w->uniq = w->keys;
    std::sort(w->uniq.begin(), w->uniq.end());
    w->uniq.erase(std::unique(w->uniq.begin(), w->uniq.end()),
                  w->uniq.end());
    return w;
}

int64_t edges_count(void* handle) {
    return static_cast<EdgeWork*>(handle)->uniq.size();
}

// cell_edges: (n_cells*n_ledges) int64; edge_verts: (n_unique*2) int32
void edges_finish(void* handle, int64_t* cell_edges, int32_t* edge_verts) {
    auto* w = static_cast<EdgeWork*>(handle);
    const auto& U = w->uniq;
    for (size_t i = 0; i < w->keys.size(); ++i) {
        cell_edges[i] = std::lower_bound(U.begin(), U.end(), w->keys[i])
                        - U.begin();
    }
    for (size_t i = 0; i < U.size(); ++i) {
        edge_verts[2 * i] = static_cast<int32_t>(U[i] / w->n_pts);
        edge_verts[2 * i + 1] = static_cast<int32_t>(U[i] % w->n_pts);
    }
    delete w;
}

// ---------------------------------------------------------------------------
// boundary_facets: facets (dim vertex ids) adjacent to exactly one cell.
// ---------------------------------------------------------------------------

struct FacetWork {
    struct Item {
        int64_t key[3];
        int32_t cell;
        int32_t local;
        int32_t verts[3];
    };
    std::vector<Item> items;
    std::vector<size_t> boundary;  // indices into items
    int32_t fdim = 0;
};

static bool key_less(const FacetWork::Item& a, const FacetWork::Item& b) {
    return std::lexicographical_compare(a.key, a.key + 3, b.key, b.key + 3);
}

static bool key_eq(const FacetWork::Item& a, const FacetWork::Item& b) {
    return std::equal(a.key, a.key + 3, b.key);
}

void* facets_begin(const int32_t* cells, int64_t n_cells, int32_t k,
                   const int32_t* lfacets, int32_t n_lfacets, int32_t fdim) {
    auto* w = new FacetWork();
    w->fdim = fdim;
    w->items.resize(static_cast<size_t>(n_cells) * n_lfacets);
    for (int64_t c = 0; c < n_cells; ++c) {
        const int32_t* row = cells + c * k;
        for (int32_t f = 0; f < n_lfacets; ++f) {
            auto& it = w->items[c * n_lfacets + f];
            int32_t v[3] = {0, 0, 0};
            for (int32_t d = 0; d < fdim; ++d)
                v[d] = row[lfacets[f * fdim + d]];
            for (int32_t d = 0; d < fdim; ++d) it.verts[d] = v[d];
            std::sort(v, v + fdim);
            it.key[0] = v[0];
            it.key[1] = fdim > 1 ? v[1] : -1;
            it.key[2] = fdim > 2 ? v[2] : -1;
            it.cell = static_cast<int32_t>(c);
            it.local = f;
        }
    }
    std::sort(w->items.begin(), w->items.end(), key_less);
    size_t n = w->items.size();
    for (size_t i = 0; i < n;) {
        size_t j = i + 1;
        while (j < n && key_eq(w->items[i], w->items[j])) ++j;
        if (j - i == 1) w->boundary.push_back(i);
        i = j;
    }
    return w;
}

int64_t facets_count(void* handle) {
    return static_cast<FacetWork*>(handle)->boundary.size();
}

void facets_finish(void* handle, int32_t* faces, int32_t* cell_ids,
                   int32_t* local_ids) {
    auto* w = static_cast<FacetWork*>(handle);
    for (size_t i = 0; i < w->boundary.size(); ++i) {
        const auto& it = w->items[w->boundary[i]];
        for (int32_t d = 0; d < w->fdim; ++d)
            faces[i * w->fdim + d] = it.verts[d];
        cell_ids[i] = it.cell;
        local_ids[i] = it.local;
    }
    delete w;
}

// ---------------------------------------------------------------------------
// scatter_plan: stable argsort of int32 target ids (the presorted
// segment-sum plan of ops/operators.py).
// ---------------------------------------------------------------------------

void scatter_plan(const int32_t* ids, int64_t n, int32_t* order,
                  int32_t* sorted_ids) {
    std::vector<int32_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);
    std::stable_sort(idx.begin(), idx.end(),
                     [ids](int32_t a, int32_t b) { return ids[a] < ids[b]; });
    for (int64_t i = 0; i < n; ++i) {
        order[i] = idx[i];
        sorted_ids[i] = ids[idx[i]];
    }
}

}  // extern "C"
