// rs_amg.cpp — classical Ruge–Stüben AMG setup (one level), C ABI.
//
// The multigrid hierarchy setup is host-side, one-time work (the reference
// delegates to AlgebraicMultigrid.jl; here the coarsening runs natively so
// million-DOF meshes set up in milliseconds instead of Python-loop minutes).
// One call computes the strength graph, the two-pass C/F splitting, and the
// positive/negative-split direct interpolation P for a CSR matrix; the
// caller (Python/scipy) performs the Galerkin RAP and loops levels.
//
// Build: g++ -O3 -march=native -shared -fPIC rs_amg.cpp -o librs_amg.so
//
// ABI:
//   long rs_level(long n, const long* indptr, const long* indices,
//                 const double* data, double theta,
//                 long* p_indptr, long* p_indices, double* p_data, long cap);
// Returns the coarse size nC (>= 0), or -1 when the output capacity `cap`
// is insufficient, or -2 on invalid input. P is (n x nC) in CSR.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

long rs_level(long n, const long* indptr, const long* indices,
              const double* data, double theta,
              long* p_indptr, long* p_indices, double* p_data, long cap) {
    if (n <= 0) return -2;

    // ---- strength of connection: -A[i,j] >= theta * max_k(-A[i,k]) ------
    std::vector<long> s_ptr(n + 1, 0);
    std::vector<long> s_idx;
    s_idx.reserve(indptr[n]);
    for (long i = 0; i < n; ++i) {
        double m = 0.0;
        for (long k = indptr[i]; k < indptr[i + 1]; ++k)
            if (indices[k] != i && -data[k] > m) m = -data[k];
        if (m > 0.0) {
            const double thr = theta * m;
            for (long k = indptr[i]; k < indptr[i + 1]; ++k)
                if (indices[k] != i && -data[k] >= thr)
                    s_idx.push_back(indices[k]);
        }
        s_ptr[i + 1] = (long)s_idx.size();
    }

    // transpose of the strength graph (who strongly depends on i)
    std::vector<long> t_cnt(n + 1, 0);
    for (long v : s_idx) t_cnt[v + 1]++;
    std::vector<long> t_ptr(n + 1, 0);
    for (long i = 0; i < n; ++i) t_ptr[i + 1] = t_ptr[i] + t_cnt[i + 1];
    std::vector<long> t_idx(s_idx.size());
    {
        std::vector<long> cur(t_ptr.begin(), t_ptr.end() - 1);
        for (long i = 0; i < n; ++i)
            for (long k = s_ptr[i]; k < s_ptr[i + 1]; ++k)
                t_idx[cur[s_idx[k]]++] = i;
    }

    // ---- first-pass CF splitting by descending influence count ----------
    std::vector<int8_t> state(n, 0);  // 0 undecided, 1 C, 2 F
    std::vector<long> lam(n);
    for (long i = 0; i < n; ++i) lam[i] = t_ptr[i + 1] - t_ptr[i];
    using QE = std::pair<long, long>;  // (lambda, node)
    std::priority_queue<QE> heap;
    for (long i = 0; i < n; ++i) heap.push({lam[i], i});
    while (!heap.empty()) {
        auto [l, i] = heap.top();
        heap.pop();
        if (state[i] != 0 || l != lam[i]) continue;
        state[i] = 1;  // C point
        for (long k = t_ptr[i]; k < t_ptr[i + 1]; ++k) {
            long j = t_idx[k];
            if (state[j] == 0) {
                state[j] = 2;  // F point
                for (long q = s_ptr[j]; q < s_ptr[j + 1]; ++q) {
                    long u = s_idx[q];
                    if (state[u] == 0) {
                        lam[u]++;
                        heap.push({lam[u], u});
                    }
                }
            }
        }
    }
    for (long i = 0; i < n; ++i)
        if (state[i] == 0) state[i] = 2;

    // ---- second pass: strong F-F pairs without a common C ---------------
    std::vector<char> mark(n, 0);
    for (long i = 0; i < n; ++i) {
        if (state[i] != 2) continue;
        long nC = 0;
        for (long k = s_ptr[i]; k < s_ptr[i + 1]; ++k)
            if (state[s_idx[k]] == 1) { mark[s_idx[k]] = 1; nC++; }
        if (nC == 0) {
            bool has_strong_F = false;
            for (long k = s_ptr[i]; k < s_ptr[i + 1]; ++k)
                if (state[s_idx[k]] == 2) { has_strong_F = true; break; }
            if (has_strong_F) state[i] = 1;  // promote
        }
        for (long k = s_ptr[i]; k < s_ptr[i + 1]; ++k) mark[s_idx[k]] = 0;
    }

    // coarse numbering
    std::vector<long> cmap(n, -1);
    long nC = 0;
    for (long i = 0; i < n; ++i)
        if (state[i] == 1) cmap[i] = nC++;
    if (nC == 0 || nC >= n) return 0;  // no useful coarsening: caller stops

    // ---- direct interpolation with pos/neg splitting ---------------------
    std::vector<char> strongC(n, 0);
    long nnz = 0;
    p_indptr[0] = 0;
    for (long i = 0; i < n; ++i) {
        if (state[i] == 1) {
            if (nnz + 1 > cap) return -1;
            p_indices[nnz] = cmap[i];
            p_data[nnz] = 1.0;
            nnz++;
            p_indptr[i + 1] = nnz;
            continue;
        }
        for (long k = s_ptr[i]; k < s_ptr[i + 1]; ++k)
            if (state[s_idx[k]] == 1) strongC[s_idx[k]] = 1;
        double aii = 0, sum_neg = 0, sum_pos = 0, cs_neg = 0, cs_pos = 0;
        long row_begin = nnz;
        for (long k = indptr[i]; k < indptr[i + 1]; ++k) {
            long c = indices[k];
            double v = data[k];
            if (c == i) { aii += v; continue; }
            if (v < 0) sum_neg += v; else sum_pos += v;
            if (strongC[c]) {
                if (v < 0) cs_neg += v; else cs_pos += v;
                if (nnz + 1 > cap) return -1;
                p_indices[nnz] = cmap[c];
                p_data[nnz] = v;  // placeholder, scaled below
                nnz++;
            }
        }
        double alpha = (cs_neg != 0.0) ? sum_neg / cs_neg : 0.0;
        double beta = (cs_pos != 0.0) ? sum_pos / cs_pos : 0.0;
        if (cs_pos == 0.0) aii += sum_pos;  // lump weak positives
        for (long k = row_begin; k < nnz; ++k) {
            double v = p_data[k];
            p_data[k] = (v < 0) ? -(alpha * v) / aii : -(beta * v) / aii;
        }
        for (long k = s_ptr[i]; k < s_ptr[i + 1]; ++k) strongC[s_idx[k]] = 0;
        p_indptr[i + 1] = nnz;
    }
    return nC;
}

}  // extern "C"
