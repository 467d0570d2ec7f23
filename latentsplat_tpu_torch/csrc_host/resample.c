/* LANCZOS and BILINEAR resizes of 8-bit interleaved images, with the
 * arithmetic of Pillow's ImagingResample (libImaging/Resample.c) for
 * Image.LANCZOS and Image.BILINEAR:
 *
 *   - a separable filter, sinc(x) * sinc(x / 3) on |x| < 3 (LANCZOS) or the
 *     triangle 1 - |x| on |x| < 1 (BILINEAR), stretched by the scale when
 *     shrinking (support 3 or 1, times max(1, in / out));
 *   - per output sample, the taps are computed in double, normalised to sum
 *     to 1 and rounded to 22-bit fixed point;
 *   - the horizontal pass runs first, over the rows the vertical pass reads,
 *     and each pass rounds and clips to 0..255 (uint8) before the next.
 *
 * Compile with -ffp-contract=off (no fused multiply-add), as Pillow's wheels
 * are, so that the taps have the same bits.
 *
 * C interface (ctypes):
 *   int resample(const uint8_t *in, int in_h, int in_w, int channels,
 *                uint8_t *out, int out_h, int out_w,
 *                int row0, int col0, int win_h, int win_w, int filter);
 * with `filter` Pillow's number for it (1 LANCZOS, 2 BILINEAR), resizes
 * (in_h, in_w) to (out_h, out_w) and writes only the window of
 * win_h x win_w output samples at (row0, col0) into `out`: a center crop
 * after the resize costs only the samples it keeps, each with the bits of
 * the whole resize. Returns 0, or -1 when out of memory or given an empty
 * size, a window outside the output or another filter.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define PRECISION_BITS (32 - 8 - 2)

static double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return sin(x) / x;
}

static double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

static double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

struct filter {
  double (*fn)(double);
  double support;
};

static const struct filter LANCZOS = {lanczos_filter, 3.0};
static const struct filter BILINEAR = {bilinear_filter, 1.0};

/* Taps of each output sample: bounds[2 * i] = first input index,
 * bounds[2 * i + 1] = count; kk[i * ksize + j] in 22-bit fixed point. */
static int precompute_coeffs(const struct filter *filter, int in_size, int out_size, int **bounds_p,
                             int32_t **kk_p) {
  double filterscale, scale = (double)((float)in_size - 0.0f) / out_size;
  double support, center, ww, ss;
  int ksize, xmin, xmax;
  int *bounds;
  double *k;
  int32_t *kk;

  filterscale = scale < 1.0 ? 1.0 : scale;
  support = filter->support * filterscale;
  ksize = (int)ceil(support) * 2 + 1;
  k = (double *)malloc((size_t)ksize * sizeof(double));
  kk = (int32_t *)malloc((size_t)out_size * ksize * sizeof(int32_t));
  bounds = (int *)malloc((size_t)out_size * 2 * sizeof(int));
  if (!k || !kk || !bounds) {
    free(k);
    free(kk);
    free(bounds);
    return -1;
  }
  for (int xx = 0; xx < out_size; xx++) {
    center = 0.0 + (xx + 0.5) * scale;
    ww = 0.0;
    ss = 1.0 / filterscale;
    xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; x++) {
      double w = filter->fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = xmax; x < ksize; x++) k[x] = 0;
    for (int x = 0; x < ksize; x++) {
      double v = k[x] * (1 << PRECISION_BITS);
      kk[xx * ksize + x] = (int32_t)(k[x] < 0 ? -0.5 + v : 0.5 + v);
    }
    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax;
  }
  free(k);
  *bounds_p = bounds;
  *kk_p = kk;
  return ksize;
}

static inline uint8_t clip8(int in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

int resample(const uint8_t *in, int in_h, int in_w, int channels, uint8_t *out, int out_h, int out_w,
             int row0, int col0, int win_h, int win_w, int filter_id) {
  const struct filter *filter = filter_id == 1 ? &LANCZOS : filter_id == 2 ? &BILINEAR : NULL;
  int *bh = NULL, *bv = NULL;
  int32_t *kh = NULL, *kv = NULL;
  int ksh, ksv, y_first = 0, y_last, rc = -1;
  uint8_t *tmp = NULL;
  int *acc = NULL;
  const uint8_t *src = in;
  int src_w = in_w, src_col0 = col0;

  if (in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || channels <= 0 || win_h <= 0 || win_w <= 0 ||
      row0 < 0 || col0 < 0 || row0 + win_h > out_h || col0 + win_w > out_w || filter == NULL)
    return -1;
  if (in_h == out_h && in_w == out_w) {
    for (int y = 0; y < win_h; y++)
      memcpy(out + (size_t)y * win_w * channels, in + ((size_t)(y + row0) * in_w + col0) * channels,
             (size_t)win_w * channels);
    return 0;
  }
  ksh = precompute_coeffs(filter, in_w, out_w, &bh, &kh);
  ksv = precompute_coeffs(filter, in_h, out_h, &bv, &kv);
  if (ksh < 0 || ksv < 0) goto done;

  if (out_w != in_w) {
    /* Horizontal pass: the window's columns, over the input rows that the
     * window's output rows read. */
    int rows;
    y_first = bv[2 * row0];
    y_last = bv[2 * (row0 + win_h - 1)] + bv[2 * (row0 + win_h - 1) + 1];
    rows = y_last - y_first;
    tmp = (uint8_t *)malloc((size_t)rows * win_w * channels);
    if (!tmp) goto done;
    for (int yy = 0; yy < rows; yy++) {
      const uint8_t *row = in + (size_t)(yy + y_first) * in_w * channels;
      uint8_t *o = tmp + (size_t)yy * win_w * channels;
      for (int xx = 0; xx < win_w; xx++) {
        int xmin = bh[2 * (xx + col0)], xmax = bh[2 * (xx + col0) + 1];
        const int32_t *k = kh + (size_t)(xx + col0) * ksh;
        for (int c = 0; c < channels; c++) {
          int ss = 1 << (PRECISION_BITS - 1);
          for (int x = 0; x < xmax; x++) ss += row[(x + xmin) * channels + c] * k[x];
          o[xx * channels + c] = clip8(ss);
        }
      }
    }
    src = tmp;
    src_w = win_w;
    src_col0 = 0;
  }
  if (out_h != in_h) {
    /* Vertical pass, row by row: the same integer sums as Pillow's column loop. */
    int n = win_w * channels;
    acc = (int *)malloc((size_t)n * sizeof(int));
    if (!acc) goto done;
    for (int yy = 0; yy < win_h; yy++) {
      int ymin = bv[2 * (yy + row0)] - y_first, ymax = bv[2 * (yy + row0) + 1];
      const int32_t *k = kv + (size_t)(yy + row0) * ksv;
      uint8_t *o = out + (size_t)yy * n;
      for (int xx = 0; xx < n; xx++) acc[xx] = 1 << (PRECISION_BITS - 1);
      for (int y = 0; y < ymax; y++) {
        const uint8_t *row = src + ((size_t)(y + ymin) * src_w + src_col0) * channels;
        int ky = k[y];
        for (int xx = 0; xx < n; xx++) acc[xx] += row[xx] * ky;
      }
      for (int xx = 0; xx < n; xx++) o[xx] = clip8(acc[xx]);
    }
  } else {
    for (int y = 0; y < win_h; y++)
      memcpy(out + (size_t)y * win_w * channels,
             src + ((size_t)(y + row0 - y_first) * src_w + src_col0) * channels, (size_t)win_w * channels);
  }
  rc = 0;
done:
  free(acc);
  free(tmp);
  free(bh);
  free(bv);
  free(kh);
  free(kv);
  return rc;
}
