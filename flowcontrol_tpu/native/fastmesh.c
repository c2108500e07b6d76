/* fastmesh — native host-side mesh/runtime kernels.
 *
 * The native counterpart of the runtime work the reference delegates to
 * dolfin's C++ core (mesh queries, dof-map construction): point location via
 * a uniform background grid, and gather-table (scatter-transpose)
 * construction for the ELL assembly layout. Called from Python through
 * ctypes (flowcontrol_tpu/native/__init__.py); pure-numpy fallbacks exist,
 * but these kernels make setup-time preprocessing O(1)-per-query /
 * single-pass.
 *
 * Build: cc -O3 -shared -fPIC fastmesh.c -o _fastmesh.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

/* ── point location ──────────────────────────────────────────────────────── */

typedef struct {
    double xmin, ymin, hx, hy;
    int nx, ny;
    /* CSR-style bins: bin_start[nx*ny+1], bin_items[...] of triangle ids */
    int64_t *bin_start;
    int32_t *bin_items;
} grid_t;

static inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

/* Locate each query point in a triangle mesh.
 *
 * coords: (nv, 2) float64, cells: (nc, 3) int32, pts: (np, 2) float64.
 * out_cell: (np,) int32 — containing cell or -1.
 * out_bary: (np, 3) float64 — barycentric coordinates.
 * Returns the number of points successfully located. */
int64_t locate_points(const double *coords, int64_t nv,
                      const int32_t *cells, int64_t nc,
                      const double *pts, int64_t np,
                      double tol,
                      int32_t *out_cell, double *out_bary)
{
    (void)nv;
    /* mesh bounding box */
    double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
    for (int64_t c = 0; c < nc; ++c) {
        for (int k = 0; k < 3; ++k) {
            const double *p = coords + 2 * (int64_t)cells[3 * c + k];
            if (p[0] < xmin) xmin = p[0];
            if (p[0] > xmax) xmax = p[0];
            if (p[1] < ymin) ymin = p[1];
            if (p[1] > ymax) ymax = p[1];
        }
    }
    int nx = (int)sqrt((double)nc) + 1;
    int ny = nx;
    grid_t g;
    g.xmin = xmin; g.ymin = ymin;
    g.hx = (xmax - xmin) / nx + 1e-300;
    g.hy = (ymax - ymin) / ny + 1e-300;
    g.nx = nx; g.ny = ny;

    int64_t nbins = (int64_t)nx * ny;
    int64_t *counts = (int64_t *)calloc(nbins + 1, sizeof(int64_t));
    if (!counts) return -1;

    /* count triangle-bin overlaps (by bbox) */
    for (int64_t c = 0; c < nc; ++c) {
        double bx0 = 1e300, bx1 = -1e300, by0 = 1e300, by1 = -1e300;
        for (int k = 0; k < 3; ++k) {
            const double *p = coords + 2 * (int64_t)cells[3 * c + k];
            if (p[0] < bx0) bx0 = p[0];
            if (p[0] > bx1) bx1 = p[0];
            if (p[1] < by0) by0 = p[1];
            if (p[1] > by1) by1 = p[1];
        }
        int i0 = clampi((int)((bx0 - g.xmin) / g.hx), 0, nx - 1);
        int i1 = clampi((int)((bx1 - g.xmin) / g.hx), 0, nx - 1);
        int j0 = clampi((int)((by0 - g.ymin) / g.hy), 0, ny - 1);
        int j1 = clampi((int)((by1 - g.ymin) / g.hy), 0, ny - 1);
        for (int i = i0; i <= i1; ++i)
            for (int j = j0; j <= j1; ++j)
                counts[(int64_t)i * ny + j + 1]++;
    }
    for (int64_t b = 0; b < nbins; ++b) counts[b + 1] += counts[b];
    int64_t total = counts[nbins];
    int32_t *items = (int32_t *)malloc(total * sizeof(int32_t));
    int64_t *cursor = (int64_t *)malloc((nbins) * sizeof(int64_t));
    if (!items || !cursor) { free(counts); free(items); free(cursor); return -1; }
    memcpy(cursor, counts, nbins * sizeof(int64_t));

    for (int64_t c = 0; c < nc; ++c) {
        double bx0 = 1e300, bx1 = -1e300, by0 = 1e300, by1 = -1e300;
        for (int k = 0; k < 3; ++k) {
            const double *p = coords + 2 * (int64_t)cells[3 * c + k];
            if (p[0] < bx0) bx0 = p[0];
            if (p[0] > bx1) bx1 = p[0];
            if (p[1] < by0) by0 = p[1];
            if (p[1] > by1) by1 = p[1];
        }
        int i0 = clampi((int)((bx0 - g.xmin) / g.hx), 0, nx - 1);
        int i1 = clampi((int)((bx1 - g.xmin) / g.hx), 0, nx - 1);
        int j0 = clampi((int)((by0 - g.ymin) / g.hy), 0, ny - 1);
        int j1 = clampi((int)((by1 - g.ymin) / g.hy), 0, ny - 1);
        for (int i = i0; i <= i1; ++i)
            for (int j = j0; j <= j1; ++j)
                items[cursor[(int64_t)i * ny + j]++] = (int32_t)c;
    }

    int64_t found = 0;
    for (int64_t q = 0; q < np; ++q) {
        const double px = pts[2 * q], py = pts[2 * q + 1];
        int i = clampi((int)((px - g.xmin) / g.hx), 0, nx - 1);
        int j = clampi((int)((py - g.ymin) / g.hy), 0, ny - 1);
        out_cell[q] = -1;
        double best = -1e300;
        /* search the point's bin, then expand rings if not found */
        for (int ring = 0; ring < (nx > ny ? nx : ny) && out_cell[q] < 0; ++ring) {
            int ilo = clampi(i - ring, 0, nx - 1), ihi = clampi(i + ring, 0, nx - 1);
            int jlo = clampi(j - ring, 0, ny - 1), jhi = clampi(j + ring, 0, ny - 1);
            for (int ii = ilo; ii <= ihi; ++ii) {
                for (int jj = jlo; jj <= jhi; ++jj) {
                    if (ring > 0 && ii > ilo && ii < ihi && jj > jlo && jj < jhi)
                        continue; /* interior of ring already searched */
                    int64_t b = (int64_t)ii * ny + jj;
                    for (int64_t t = counts[b]; t < counts[b + 1]; ++t) {
                        int32_t c = items[t];
                        const double *p0 = coords + 2 * (int64_t)cells[3 * c];
                        const double *p1 = coords + 2 * (int64_t)cells[3 * c + 1];
                        const double *p2 = coords + 2 * (int64_t)cells[3 * c + 2];
                        double d = (p1[0] - p0[0]) * (p2[1] - p0[1])
                                 - (p2[0] - p0[0]) * (p1[1] - p0[1]);
                        double w1 = ((p1[0] - px) * (p2[1] - py)
                                   - (p2[0] - px) * (p1[1] - py)) / d;
                        double w2 = ((p2[0] - px) * (p0[1] - py)
                                   - (p0[0] - px) * (p2[1] - py)) / d;
                        double w3 = 1.0 - w1 - w2;
                        double m = w1 < w2 ? (w1 < w3 ? w1 : w3)
                                           : (w2 < w3 ? w2 : w3);
                        if (m > best) best = m;
                        if (m >= -tol) {
                            out_cell[q] = c;
                            out_bary[3 * q] = w1;
                            out_bary[3 * q + 1] = w2;
                            out_bary[3 * q + 2] = w3;
                            found++;
                            goto next_point;
                        }
                    }
                }
            }
        }
next_point:;
    }
    free(counts); free(items); free(cursor);
    return found;
}

/* ── gather-table construction (scatter transpose, ELL layout) ──────────── */

/* Count max contributions per dof. Returns kmax. */
int64_t gather_table_kmax(const int32_t *dofs_flat, int64_t m, int64_t n_dofs)
{
    int64_t *counts = (int64_t *)calloc(n_dofs, sizeof(int64_t));
    if (!counts) return -1;
    int64_t kmax = 0;
    for (int64_t i = 0; i < m; ++i) {
        int64_t c = ++counts[dofs_flat[i]];
        if (c > kmax) kmax = c;
    }
    free(counts);
    return kmax;
}

/* Fill table (n_dofs, kmax) with source indices; pad slots = m. */
int64_t gather_table_fill(const int32_t *dofs_flat, int64_t m, int64_t n_dofs,
                          int64_t kmax, int32_t *table)
{
    int64_t *cursor = (int64_t *)calloc(n_dofs, sizeof(int64_t));
    if (!cursor) return -1;
    for (int64_t i = 0; i < n_dofs * kmax; ++i) table[i] = (int32_t)m;
    for (int64_t i = 0; i < m; ++i) {
        int64_t d = dofs_flat[i];
        table[d * kmax + cursor[d]++] = (int32_t)i;
    }
    free(cursor);
    return 0;
}
