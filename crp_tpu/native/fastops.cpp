// Native host-side hot paths for crp_tpu, loaded via ctypes.
//
// The reference keeps its planner and I/O in C for speed (src/spmat_part.c,
// examples/mmio_utils.c); these are this library's equivalents — the
// pieces that stay on the host CPU and dominate plan/init time at
// 100M-nnz scale:
//   * crp_comm_size        — exact per-block SpMV comm volume (the planner's
//                            hot loop, algorithmically matching
//                            csr_mat_row_part_comm_size semantics)
//   * crp_coo2csr_*        — COO -> column-sorted CSR
//   * crp_mtx_read         — buffered Matrix Market coordinate parser with
//                            symmetric mirror expansion
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC fastops.cpp -o libcrpfast.so

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Exact SpMV comm volume per row block: distinct columns touched by the
// block's rows minus distinct touched columns inside the block's owned
// x-range.  nnz_bounds[i] = first nnz index of block i (nblk+1 entries).
void crp_comm_size(
    int64_t ncol, int64_t nblk,
    const int64_t* nnz_bounds, const int32_t* colidx,
    const int64_t* x_displs, int64_t* comm_sizes)
{
#pragma omp parallel
    {
        std::vector<uint8_t> flag(ncol, 0);
#pragma omp for schedule(dynamic)
        for (int64_t b = 0; b < nblk; b++) {
            std::fill(flag.begin(), flag.end(), 0);
            for (int64_t j = nnz_bounds[b]; j < nnz_bounds[b + 1]; j++)
                flag[colidx[j]] = 1;
            int64_t cnt = 0;
            for (int64_t c = 0; c < ncol; c++) cnt += flag[c];
            for (int64_t c = x_displs[b]; c < x_displs[b + 1]; c++)
                cnt -= flag[c];
            comm_sizes[b] = cnt;
        }
    }
}

// COO -> CSR with per-row column-sorted entries (duplicates kept).
static void coo2csr_impl(
    int64_t nrow, int64_t nnz,
    const int64_t* rows, const int64_t* cols, const double* vals,
    int64_t* rowptr, int32_t* colidx, double* csrval)
{
    std::memset(rowptr, 0, sizeof(int64_t) * (nrow + 1));
    for (int64_t i = 0; i < nnz; i++) rowptr[rows[i] + 1]++;
    for (int64_t i = 0; i < nrow; i++) rowptr[i + 1] += rowptr[i];
    std::vector<int64_t> pos(rowptr, rowptr + nrow);
    for (int64_t i = 0; i < nnz; i++) {
        int64_t p = pos[rows[i]]++;
        colidx[p] = (int32_t)cols[i];
        csrval[p] = vals[i];
    }
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t r = 0; r < nrow; r++) {
        int64_t s = rowptr[r], e = rowptr[r + 1];
        std::vector<std::pair<int32_t, double>> tmp;
        tmp.reserve(e - s);
        for (int64_t j = s; j < e; j++) tmp.emplace_back(colidx[j], csrval[j]);
        std::stable_sort(tmp.begin(), tmp.end(),
                         [](auto& a, auto& b) { return a.first < b.first; });
        for (int64_t j = s; j < e; j++) {
            colidx[j] = tmp[j - s].first;
            csrval[j] = tmp[j - s].second;
        }
    }
}

void crp_coo2csr(
    int64_t nrow, int64_t nnz,
    const int64_t* rows, const int64_t* cols, const double* vals,
    int64_t* rowptr, int32_t* colidx, double* csrval)
{
    coo2csr_impl(nrow, nnz, rows, cols, vals, rowptr, colidx, csrval);
}

// Matrix Market coordinate parser.  Two-phase: stat then read.
// field: 0 real/double, 1 integer, 2 pattern.  symm: 0 general, 1 symmetric.
int crp_mtx_stat(const char* path, int64_t* nrow, int64_t* ncol,
                 int64_t* nnz_stored, int* symm, int* field)
{
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    char line[1024];
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
    for (char* p = line; *p; p++) *p = (char)std::tolower(*p);
    if (!std::strstr(line, "%%matrixmarket") ||
        !std::strstr(line, "coordinate")) { std::fclose(f); return -3; }
    *field = std::strstr(line, "pattern") ? 2
           : std::strstr(line, "integer") ? 1 : 0;
    if (std::strstr(line, "complex") || std::strstr(line, "hermitian") ||
        std::strstr(line, "skew")) { std::fclose(f); return -4; }
    *symm = std::strstr(line, "symmetric") ? 1 : 0;
    while (std::fgets(line, sizeof line, f))
        if (line[0] != '%') break;
    long long m, n, z;
    if (std::sscanf(line, "%lld %lld %lld", &m, &n, &z) != 3) {
        std::fclose(f);
        return -5;
    }
    *nrow = m; *ncol = n; *nnz_stored = z;
    std::fclose(f);
    return 0;
}

// Read entries (0-based output).  rows/cols/vals must have capacity for
// nnz_stored * (symmetric expansion ? 2 : 1).  Returns final nnz or < 0.
int64_t crp_mtx_read(const char* path, int64_t nnz_stored, int expand_symm,
                     int field, int64_t* rows, int64_t* cols, double* vals)
{
    FILE* f = std::fopen(path, "r");
    if (!f) return -1;
    char line[1024];
    // skip banner + comments + size line
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -2; }
    while (std::fgets(line, sizeof line, f))
        if (line[0] != '%') break;  // size line consumed
    int64_t idx = 0;
    for (int64_t i = 0; i < nnz_stored; i++) {
        if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return -6; }
        char* p = line;
        int64_t r = std::strtoll(p, &p, 10) - 1;
        int64_t c = std::strtoll(p, &p, 10) - 1;
        double v = (field == 2) ? 1.0 : std::strtod(p, &p);
        rows[idx] = r; cols[idx] = c; vals[idx] = v;
        idx++;
        if (expand_symm && r != c) {
            rows[idx] = c; cols[idx] = r; vals[idx] = v;
            idx++;
        }
    }
    std::fclose(f);
    return idx;
}

// Greedy graph-growing K-way row partition: the native engine behind the
// METIS seam when no libmetis/pymetis is installed (the reference links
// METIS_PartGraphKway, examples/metis_mat_part.c:44-62).  Parts are grown
// one at a time from a minimum-degree seed, repeatedly absorbing the
// frontier vertex with the most neighbors already inside the growing part
// (the GGGP gain METIS itself uses for its initial partitions), under a
// per-part size target of ceil(remaining / parts_left) capped at
// imbalance * nrow / nparts (the ubvec analog).  Disconnected components
// re-seed within the current part.  part_out[i] in [0, nparts).
int crp_ggp_partition(
    int64_t nrow, const int64_t* rowptr, const int32_t* colidx,
    int64_t nparts, double imbalance, int32_t* part_out)
{
    if (nrow <= 0) return 0;
    if (nparts <= 1) {
        for (int64_t i = 0; i < nrow; i++) part_out[i] = 0;
        return 0;
    }
    std::vector<int32_t> part(nrow, -1);
    std::vector<int64_t> by_deg(nrow);
    for (int64_t i = 0; i < nrow; i++) by_deg[i] = i;
    std::sort(by_deg.begin(), by_deg.end(), [&](int64_t a, int64_t b) {
        return (rowptr[a + 1] - rowptr[a]) < (rowptr[b + 1] - rowptr[b]);
    });
    int64_t seed_cursor = 0;
    // per-vertex "neighbors inside the current part", reset lazily by stamp
    std::vector<int64_t> in_cur(nrow, 0);
    std::vector<int32_t> stamp(nrow, -1);
    int64_t remaining = nrow;
    const int64_t cap =
        (int64_t)(imbalance * ((double)nrow / (double)nparts)) + 1;
    for (int32_t p = 0; p < (int32_t)nparts; p++) {
        int64_t parts_left = (int64_t)nparts - p;
        int64_t target = (remaining + parts_left - 1) / parts_left;
        if (target > cap) target = cap;
        if (p == (int32_t)nparts - 1) target = remaining;
        // lazy max-heap of (gain, vertex); stale entries skipped on pop
        std::priority_queue<std::pair<int64_t, int64_t>> heap;
        int64_t size = 0;
        while (size < target && remaining > 0) {
            int64_t v = -1;
            while (!heap.empty()) {
                std::pair<int64_t, int64_t> top = heap.top();
                heap.pop();
                int64_t u = top.second;
                if (part[u] != -1) continue;
                int64_t cur = (stamp[u] == p) ? in_cur[u] : 0;
                if (top.first != cur) { heap.push({cur, u}); continue; }
                v = u;
                break;
            }
            if (v == -1) {  // fresh part, or component exhausted: new seed
                while (seed_cursor < nrow && part[by_deg[seed_cursor]] != -1)
                    seed_cursor++;
                if (seed_cursor >= nrow) break;
                v = by_deg[seed_cursor];
            }
            part[v] = p;
            size++;
            remaining--;
            for (int64_t e = rowptr[v]; e < rowptr[v + 1]; e++) {
                int64_t w = colidx[e];
                if (w < 0 || w >= nrow || w == v || part[w] != -1) continue;
                if (stamp[w] != p) { stamp[w] = p; in_cur[w] = 0; }
                in_cur[w]++;
                heap.push({in_cur[w], w});
            }
        }
    }
    for (int64_t i = 0; i < nrow; i++)
        if (part[i] == -1) part[i] = (int32_t)(nparts - 1);
    std::copy(part.begin(), part.end(), part_out);
    return 0;
}

}  // extern "C"
