// Column chunks of one element's panel rows in shared memory: the wide
// forms of K1 (panel_fwd.cu) and K4 (gram_matvec.cu), for an element whose
// nD panel slabs (nD x p x C doubles) do not fit in a block's shared memory
// together; K1's spread form stages its rows in the same layout.
//
// Row r = q*nD + k of a chunk (the layout of the (N*p, nD) node values)
// holds panels[k, e, q, c0 .. c0+n-1]. Each row is staged with cp.async at
// its source's parity (cpasync.cuh), at dst + r*ld + odd8(source), ld
// even; a reader finds its row's start with panel_row and odd8 as well.
#pragma once
#include <cstddef>

#include "cpasync.cuh"

// Row r of element pe's panels (pe = panels + e*p*C), column 0.
__device__ __forceinline__ const double* panel_row(const double* pe,
                                                   size_t kstride, int C,
                                                   int nD, int r) {
    const int q = r / nD, k = r - q * nD;
    return pe + k * kstride + (size_t)q * C;
}

// Columns c0 .. c0+n-1 of the element's rows 0 .. rows-1, by threads t,
// t + nt, ... (the caller commits and waits).
__device__ __forceinline__ void cp_panel_chunk(double* dst, int ld,
                                               const double* pe,
                                               size_t kstride, int C, int nD,
                                               int rows, int c0, int n, int t,
                                               int nt) {
    const int np = cp_pieces(n, 1);  // the most pieces a row takes
    for (int i = t; i < rows * np; i += nt) {
        const int r = i / np, j = i - r * np;
        const double* src = panel_row(pe, kstride, C, nD, r) + c0;
        const int h = odd8(src);
        if (j < cp_pieces(n, h))
            cp_piece(dst + (size_t)r * ld + h, src, n, h, j);
    }
}

// Columns a chunk takes: the most, a multiple of 4, for which rows chunk
// rows of stride cc + 2 and `fixed` other doubles fit in `budget` bytes
// (the stride then holds an odd number of 16-byte pairs: a half-warp's
// reads of neighbouring rows meet at most two to a bank); at least 4, and
// no more than C needs. Returns 0 when not even 4 fit.
static inline int chunk_cols(int rows, size_t fixed, size_t budget, int C) {
    const size_t room = budget / sizeof(double);
    if (room < fixed + (size_t)rows * 6) return 0;
    int cc = (int)((room - fixed) / rows) - 2;
    cc &= ~3;
    const int need = (C + 3) & ~3;
    return cc < need ? cc : need;
}
