// Native k-d tree for host-side neighbor search.
//
// The reference leans on scipy.spatial.cKDTree for the global-interpolation
// kNN/radius queries (reference: wlsqm/fitter/expert.pyx:658-681).  This is
// the rebuild's own native runtime piece: a compact median-split k-d tree
// over 1-3D point clouds with k-NN and radius queries, multithreaded over
// queries, exposed through a plain C ABI consumed via ctypes
// (wlsqm_tpu_torch/native/__init__.py; a copy of wlsqm_tpu/native/kdtree.cpp).
//
// Design notes:
//  * nodes are stored implicitly in a flat array (heap layout) built by
//    iterative median partitioning (nth_element) — no per-node allocation;
//  * queries keep a bounded max-heap of candidates on the stack;
//  * all distances are squared euclidean, matching the weight function's
//    d^2 convention.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Tree {
    int dim = 0;
    int64_t n = 0;
    std::vector<double> pts;      // (n, dim), reordered
    std::vector<int64_t> index;   // reordered -> original index
    std::vector<int> axis;        // split axis per node (-1 = leaf run)
    std::vector<double> split;    // split value per node (recorded at build
                                  // time — child partitions reshuffle pts,
                                  // so it cannot be re-read from the array)
    int64_t leaf_size = 16;
};

struct Frame {
    int64_t lo, hi, node;
};

void build_range(Tree& t, int64_t lo, int64_t hi, int64_t node) {
    // iterative build over an explicit stack
    std::vector<Frame> stack;
    stack.push_back({lo, hi, node});
    while (!stack.empty()) {
        Frame f = stack.back();
        stack.pop_back();
        const int64_t count = f.hi - f.lo;
        if (count <= t.leaf_size) {
            if ((size_t)f.node < t.axis.size()) t.axis[f.node] = -1;
            continue;
        }
        // pick the axis with the largest spread
        int best_axis = 0;
        double best_spread = -1.0;
        for (int a = 0; a < t.dim; ++a) {
            double mn = 1e300, mx = -1e300;
            for (int64_t i = f.lo; i < f.hi; ++i) {
                const double v = t.pts[i * t.dim + a];
                mn = std::min(mn, v);
                mx = std::max(mx, v);
            }
            if (mx - mn > best_spread) {
                best_spread = mx - mn;
                best_axis = a;
            }
        }
        const int64_t mid = f.lo + count / 2;
        // partition point rows around the median along best_axis
        std::vector<int64_t> order(count);
        for (int64_t i = 0; i < count; ++i) order[i] = i;
        const int axis = best_axis;
        std::nth_element(
            order.begin(), order.begin() + count / 2, order.end(),
            [&](int64_t a, int64_t b) {
                return t.pts[(f.lo + a) * t.dim + axis]
                     < t.pts[(f.lo + b) * t.dim + axis];
            });
        // apply permutation to pts/index for this range
        std::vector<double> tmp_p(count * t.dim);
        std::vector<int64_t> tmp_i(count);
        for (int64_t i = 0; i < count; ++i) {
            std::memcpy(&tmp_p[i * t.dim], &t.pts[(f.lo + order[i]) * t.dim],
                        t.dim * sizeof(double));
            tmp_i[i] = t.index[f.lo + order[i]];
        }
        std::memcpy(&t.pts[f.lo * t.dim], tmp_p.data(),
                    tmp_p.size() * sizeof(double));
        std::memcpy(&t.index[f.lo], tmp_i.data(),
                    tmp_i.size() * sizeof(int64_t));

        if ((size_t)f.node >= t.axis.size()) {
            t.axis.resize(f.node + 1, -2);
            t.split.resize(f.node + 1, 0.0);
        }
        t.axis[f.node] = axis;
        t.split[f.node] = t.pts[mid * t.dim + axis];
        stack.push_back({f.lo, mid, 2 * f.node + 1});
        stack.push_back({mid, f.hi, 2 * f.node + 2});
    }
}

struct Candidate {
    double d2;
    int64_t idx;
    bool operator<(const Candidate& o) const { return d2 < o.d2; }
};

void knn_recurse(const Tree& t, const double* q, int k,
                 std::vector<Candidate>& heap,
                 int64_t lo, int64_t hi, int64_t node) {
    const int axis = ((size_t)node < t.axis.size()) ? t.axis[node] : -1;
    if (axis < 0 || hi - lo <= t.leaf_size) {
        for (int64_t i = lo; i < hi; ++i) {
            double d2 = 0.0;
            for (int a = 0; a < t.dim; ++a) {
                const double d = t.pts[i * t.dim + a] - q[a];
                d2 += d * d;
            }
            if ((int)heap.size() < k) {
                heap.push_back({d2, t.index[i]});
                std::push_heap(heap.begin(), heap.end());
            } else if (d2 < heap.front().d2) {
                std::pop_heap(heap.begin(), heap.end());
                heap.back() = {d2, t.index[i]};
                std::push_heap(heap.begin(), heap.end());
            }
        }
        return;
    }
    const int64_t mid = lo + (hi - lo) / 2;
    const double split = t.split[node];
    const double delta = q[axis] - split;
    const bool go_left_first = delta < 0.0;
    if (go_left_first) {
        knn_recurse(t, q, k, heap, lo, mid, 2 * node + 1);
        if ((int)heap.size() < k || delta * delta < heap.front().d2)
            knn_recurse(t, q, k, heap, mid, hi, 2 * node + 2);
    } else {
        knn_recurse(t, q, k, heap, mid, hi, 2 * node + 2);
        if ((int)heap.size() < k || delta * delta < heap.front().d2)
            knn_recurse(t, q, k, heap, lo, mid, 2 * node + 1);
    }
}

void radius_recurse(const Tree& t, const double* q, double r2,
                    std::vector<int64_t>& out,
                    int64_t lo, int64_t hi, int64_t node) {
    const int axis = ((size_t)node < t.axis.size()) ? t.axis[node] : -1;
    if (axis < 0 || hi - lo <= t.leaf_size) {
        for (int64_t i = lo; i < hi; ++i) {
            double d2 = 0.0;
            for (int a = 0; a < t.dim; ++a) {
                const double d = t.pts[i * t.dim + a] - q[a];
                d2 += d * d;
            }
            if (d2 <= r2) out.push_back(t.index[i]);
        }
        return;
    }
    const int64_t mid = lo + (hi - lo) / 2;
    const double split = t.split[node];
    const double delta = q[axis] - split;
    if (delta < 0.0 || delta * delta <= r2)
        radius_recurse(t, q, r2, out, lo, mid, 2 * node + 1);
    if (delta >= 0.0 || delta * delta <= r2)
        radius_recurse(t, q, r2, out, mid, hi, 2 * node + 2);
}

void parallel_for(int64_t n, int nthreads,
                  const std::function<void(int64_t, int64_t)>& body) {
    if (nthreads <= 1 || n < 2048) {
        body(0, n);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t block = (n + nthreads - 1) / nthreads;
    for (int t0 = 0; t0 < nthreads; ++t0) {
        const int64_t lo = t0 * block;
        const int64_t hi = std::min<int64_t>(n, lo + block);
        if (lo >= hi) break;
        ts.emplace_back(body, lo, hi);
    }
    for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

void* wlsqm_kdtree_build(const double* points, int64_t n, int dim) {
    Tree* t = new Tree();
    t->dim = dim;
    t->n = n;
    t->pts.assign(points, points + n * dim);
    t->index.resize(n);
    for (int64_t i = 0; i < n; ++i) t->index[i] = i;
    t->axis.assign(1, -2);
    t->split.assign(1, 0.0);
    build_range(*t, 0, n, 0);
    return t;
}

void wlsqm_kdtree_free(void* handle) { delete static_cast<Tree*>(handle); }

// out_idx: (m, k) int64; out_d2: (m, k) double; fewer than k points -> padded
// with -1 / inf.
void wlsqm_kdtree_knn(void* handle, const double* queries, int64_t m, int k,
                      int64_t* out_idx, double* out_d2, int nthreads) {
    const Tree& t = *static_cast<Tree*>(handle);
    parallel_for(m, nthreads, [&](int64_t lo, int64_t hi) {
        std::vector<Candidate> heap;
        heap.reserve(k);
        for (int64_t qi = lo; qi < hi; ++qi) {
            heap.clear();
            knn_recurse(t, queries + qi * t.dim, k, heap, 0, t.n, 0);
            std::sort_heap(heap.begin(), heap.end());
            for (int j = 0; j < k; ++j) {
                if (j < (int)heap.size()) {
                    out_idx[qi * k + j] = heap[j].idx;
                    out_d2[qi * k + j] = heap[j].d2;
                } else {
                    out_idx[qi * k + j] = -1;
                    out_d2[qi * k + j] = INFINITY;
                }
            }
        }
    });
}

// Two-pass radius query: first call with out=nullptr fills counts; second
// call fills the concatenated index list (caller allocates from the counts).
void wlsqm_kdtree_radius(void* handle, const double* queries, int64_t m,
                         double r, int64_t* counts, int64_t* out,
                         int nthreads) {
    const Tree& t = *static_cast<Tree*>(handle);
    const double r2 = r * r;
    if (out == nullptr) {
        parallel_for(m, nthreads, [&](int64_t lo, int64_t hi) {
            std::vector<int64_t> buf;
            for (int64_t qi = lo; qi < hi; ++qi) {
                buf.clear();
                radius_recurse(t, queries + qi * t.dim, r2, buf, 0, t.n, 0);
                counts[qi] = (int64_t)buf.size();
            }
        });
        return;
    }
    // offsets from counts (exclusive prefix sum, done by caller convention:
    // counts[] already holds per-query counts from pass one)
    std::vector<int64_t> offset(m + 1, 0);
    for (int64_t i = 0; i < m; ++i) offset[i + 1] = offset[i] + counts[i];
    parallel_for(m, nthreads, [&](int64_t lo, int64_t hi) {
        std::vector<int64_t> buf;
        for (int64_t qi = lo; qi < hi; ++qi) {
            buf.clear();
            radius_recurse(t, queries + qi * t.dim, r2, buf, 0, t.n, 0);
            std::sort(buf.begin(), buf.end());
            std::copy(buf.begin(), buf.end(), out + offset[qi]);
        }
    });
}

}  // extern "C"
