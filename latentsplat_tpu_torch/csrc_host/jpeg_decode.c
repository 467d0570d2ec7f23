/* A baseline / extended-sequential JPEG decoder for the host.
 *
 * Decodes SOF0 and SOF1 files of 8-bit precision with Huffman coding: one
 * (grayscale) or three (YCbCr) components with sampling factors of 1 or 2
 * per axis, restart intervals, any number of DQT (8- or 16-bit) and DHT
 * tables, APPn and COM segments skipped. The output is interleaved RGB;
 * grayscale is replicated to the three channels.
 *
 * The arithmetic is libjpeg-turbo's default decompression path, so that the
 * output has the same bits as libjpeg-turbo's (and PIL's) decode:
 *   - the accurate integer inverse DCT ("islow", jidctint.c), 13-bit
 *     constants and 2 extra bits between its passes, clamped to 0..255;
 *   - "fancy" (triangle-filter) upsampling of subsampled planes
 *     (jdsample.c: h2v1, h1v2 and h2v2), edges replicated;
 *   - YCbCr -> RGB through 16-bit fixed-point tables (jdcolor.c).
 * Progressive, lossless, hierarchical and arithmetic-coded files, 12-bit
 * samples, 4-component (CMYK / YCCK) and RGB-coded (Adobe transform 0)
 * files are refused with a message that names the marker.
 *
 * C interface (ctypes):
 *   int jpeg_header(const uint8_t *data, long size, int *width, int *height,
 *                   int *components, char *err, int err_size);
 *   int jpeg_decode(const uint8_t *data, long size, uint8_t *rgb, int width,
 *                   int height, char *err, int err_size);
 * Both return 0 on success, else write a message into `err` and return -1
 * for a damaged file (truncated, corrupt tables or data, not a JPEG) or -2
 * for a valid file of a mode the decoder does not take. `rgb` holds
 * height * width * 3 bytes.
 */

#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  /* Codes of up to LOOKAHEAD bits by table: (length << 8) | symbol, 0 if
   * longer. Longer codes go through maxcode / valptr as in the standard. */
  uint16_t fast[1 << 9];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  int defined;
} huff_t;

#define LOOKAHEAD 9

typedef struct {
  int id, h, v, tq;
  int td, ta;          /* Huffman tables of the current scan */
  int bw, bh;          /* blocks across / down in the plane */
  int dw, dh;          /* downsampled width / height (libjpeg's rounding) */
  uint8_t *plane;      /* bw * 8 x bh * 8 samples */
  int pred;            /* DC prediction */
} comp_t;

typedef struct {
  const uint8_t *data, *end, *p;
  uint64_t acc;
  int nbits;
  int at_marker;
} bits_t;

typedef struct {
  int width, height, ncomp;
  int hmax, vmax, mcux, mcuy;
  int restart_interval;
  int saw_frame, saw_jfif, adobe_transform; /* -1: no Adobe segment */
  int unsupported;     /* the failure is a mode not taken, not damage */
  int16_t qt[4][64];   /* natural order, as libjpeg's ISLOW_MULT_TYPE */
  int qt_defined[4];
  huff_t dc[4], ac[4];
  comp_t comp[3];
  char *err;
  int err_size;
} dec_t;

static const int natural_order[64 + 16] = {
  0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
  35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
  58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
  /* extra entries for corrupt runs past the end, as libjpeg has */
  63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63
};

static int fail(dec_t *d, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  if (d->err && d->err_size > 0) vsnprintf(d->err, (size_t)d->err_size, fmt, ap);
  va_end(ap);
  return -1;
}

/* As fail, for a valid file of a mode the decoder does not take. */
static int refuse(dec_t *d, const char *fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  if (d->err && d->err_size > 0) vsnprintf(d->err, (size_t)d->err_size, fmt, ap);
  va_end(ap);
  d->unsupported = 1;
  return -1;
}

static int read_u16(const uint8_t *p) { return (p[0] << 8) | p[1]; }

/* -- tables ------------------------------------------------------------ */

static int read_dqt(dec_t *d, const uint8_t *p, int len) {
  int pos = 0;
  while (pos < len) {
    int pq = p[pos] >> 4, tq = p[pos] & 15;
    int n = pq ? 128 : 64;
    if (tq > 3) return fail(d, "DQT: table %d out of range", tq);
    if (pq > 1) return fail(d, "DQT: precision %d", pq);
    if (pos + 1 + n > len) return fail(d, "DQT: truncated segment");
    for (int i = 0; i < 64; i++) {
      int q = pq ? read_u16(p + pos + 1 + 2 * i) : p[pos + 1 + i];
      d->qt[tq][natural_order[i]] = (int16_t)q;
    }
    d->qt_defined[tq] = 1;
    pos += 1 + n;
  }
  return 0;
}

static int build_huff(dec_t *d, huff_t *t, const uint8_t *counts, const uint8_t *vals, int nvals) {
  int code = 0, k = 0;
  memset(t, 0, sizeof(*t));
  memcpy(t->huffval, vals, (size_t)nvals);
  for (int len = 1; len <= 16; len++) {
    t->valoffset[len] = k - code;
    /* No code may be all ones (jdhuff.c's JERR_BAD_HUFF_TABLE); checked
     * before the fill, which indexes `fast` by code. */
    if (code + counts[len - 1] >= (1 << len)) return fail(d, "DHT: bad code lengths");
    if (counts[len - 1]) {
      for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
        if (len <= LOOKAHEAD) {
          int shift = LOOKAHEAD - len;
          for (int j = 0; j < (1 << shift); j++)
            t->fast[(code << shift) | j] = (uint16_t)((len << 8) | vals[k]);
        }
      }
      t->maxcode[len] = code - 1;
    } else {
      t->maxcode[len] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  t->defined = 1;
  return 0;
}

static int read_dht(dec_t *d, const uint8_t *p, int len) {
  int pos = 0;
  while (pos < len) {
    int tc, th, total = 0;
    if (pos + 17 > len) return fail(d, "DHT: truncated segment");
    tc = p[pos] >> 4;
    th = p[pos] & 15;
    if (tc > 1 || th > 3) return fail(d, "DHT: table class %d / index %d", tc, th);
    for (int i = 0; i < 16; i++) total += p[pos + 1 + i];
    if (total > 256 || pos + 17 + total > len) return fail(d, "DHT: bad symbol count");
    if (build_huff(d, tc ? &d->ac[th] : &d->dc[th], p + pos + 1, p + pos + 17, total)) return -1;
    pos += 17 + total;
  }
  return 0;
}

/* -- entropy-coded data ------------------------------------------------- */

static void fill(bits_t *b) {
  while (b->nbits <= 56) {
    unsigned byte = 0;
    if (!b->at_marker && b->p < b->end) {
      byte = *b->p;
      if (byte == 0xFF) {
        unsigned next = b->p + 1 < b->end ? b->p[1] : 0xD9;
        if (next == 0x00) {
          b->p += 2;
        } else {
          b->at_marker = 1;   /* pad with zeros from here, as libjpeg does */
          byte = 0;
        }
      } else {
        b->p++;
      }
    }
    b->acc |= (uint64_t)byte << (56 - b->nbits);
    b->nbits += 8;
  }
}

static int get_bits(bits_t *b, int n) {
  int v;
  if (n == 0) return 0;
  if (b->nbits < n) fill(b);
  v = (int)(b->acc >> (64 - n));
  b->acc <<= n;
  b->nbits -= n;
  return v;
}

static int decode_symbol(bits_t *b, const huff_t *t) {
  int look, code, len;
  if (b->nbits < 16) fill(b);
  look = (int)(b->acc >> (64 - LOOKAHEAD));
  if (t->fast[look]) {
    len = t->fast[look] >> 8;
    b->acc <<= len;
    b->nbits -= len;
    return t->fast[look] & 0xFF;
  }
  code = (int)(b->acc >> (64 - (LOOKAHEAD + 1)));
  for (len = LOOKAHEAD + 1; len <= 16; len++) {
    if (code <= t->maxcode[len]) break;
    code = (int)(b->acc >> (64 - (len + 1)));
  }
  if (len > 16) return -1;
  code = (int)(b->acc >> (64 - len));
  b->acc <<= len;
  b->nbits -= len;
  return t->huffval[(code + t->valoffset[len]) & 0xFF];
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* -- inverse DCT (jidctint.c, jpeg_idct_islow) --------------------------- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

static inline uint8_t clamp_sample(int64_t x) {
  /* libjpeg-turbo's SIMD IDCT saturates; its C range-limit table agrees for
   * every value within +-512 of the center. */
  x += 128;
  return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x);
}

static void idct_islow(const int16_t *coef, const int16_t *q, uint8_t *out, int stride) {
  int ws[64];
  int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;

  for (int c = 0; c < 8; c++) {
    const int16_t *in = coef + c;
    const int16_t *qq = q + c;
    int *w = ws + c;
    z2 = (int64_t)in[16] * qq[16];
    z3 = (int64_t)in[48] * qq[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qq[0];
    z3 = (int64_t)in[32] * qq[32];
    tmp0 = (z2 + z3) * (1 << CONST_BITS);
    tmp1 = (z2 - z3) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;

    tmp0 = (int64_t)in[56] * qq[56];
    tmp1 = (int64_t)in[40] * qq[40];
    tmp2 = (int64_t)in[24] * qq[24];
    tmp3 = (int64_t)in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }

  for (int r = 0; r < 8; r++) {
    const int *w = ws + 8 * r;
    uint8_t *o = out + (size_t)r * stride;
    const int n = CONST_BITS + PASS1_BITS + 3;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    o[0] = clamp_sample(DESCALE(tmp10 + tmp3, n));
    o[7] = clamp_sample(DESCALE(tmp10 - tmp3, n));
    o[1] = clamp_sample(DESCALE(tmp11 + tmp2, n));
    o[6] = clamp_sample(DESCALE(tmp11 - tmp2, n));
    o[2] = clamp_sample(DESCALE(tmp12 + tmp1, n));
    o[5] = clamp_sample(DESCALE(tmp12 - tmp1, n));
    o[3] = clamp_sample(DESCALE(tmp13 + tmp0, n));
    o[4] = clamp_sample(DESCALE(tmp13 - tmp0, n));
  }
}

/* -- frame and scan ----------------------------------------------------- */

static int read_sof(dec_t *d, const uint8_t *p, int len) {
  if (d->saw_frame) return fail(d, "a second frame header (SOF)");
  if (len < 6) return fail(d, "SOF: truncated segment");
  if (p[0] != 8) return refuse(d, "SOF: %d-bit samples are not supported (8-bit only)", p[0]);
  d->height = read_u16(p + 1);
  d->width = read_u16(p + 3);
  d->ncomp = p[5];
  if (d->height == 0) return refuse(d, "SOF: height 0 (a DNL marker) is not supported");
  if (d->width == 0) return fail(d, "SOF: width 0");
  if (d->ncomp == 4) return refuse(d, "SOF: 4 components (CMYK / YCCK) are not supported");
  if (d->ncomp != 1 && d->ncomp != 3) return refuse(d, "SOF: %d components are not supported", d->ncomp);
  if (len < 6 + 3 * d->ncomp) return fail(d, "SOF: truncated segment");
  d->hmax = d->vmax = 1;
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    c->id = p[6 + 3 * i];
    c->h = p[7 + 3 * i] >> 4;
    c->v = p[7 + 3 * i] & 15;
    c->tq = p[8 + 3 * i];
    if (c->h < 1 || c->h > 2 || c->v < 1 || c->v > 2)
      return refuse(d, "SOF: sampling factors %dx%d (1 or 2 per axis only)", c->h, c->v);
    if (c->tq > 3) return fail(d, "SOF: quantization table %d", c->tq);
    if (c->h > d->hmax) d->hmax = c->h;
    if (c->v > d->vmax) d->vmax = c->v;
  }
  if (d->ncomp == 1) d->comp[0].h = d->comp[0].v = d->hmax = d->vmax = 1; /* one block per MCU */
  d->mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
  d->mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    c->dw = (int)(((long)d->width * c->h + d->hmax - 1) / d->hmax);
    c->dh = (int)(((long)d->height * c->v + d->vmax - 1) / d->vmax);
    c->bw = d->mcux * c->h;
    c->bh = d->mcuy * c->v;
  }
  d->saw_frame = 1;
  return 0;
}

static int alloc_planes(dec_t *d) {
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    c->plane = (uint8_t *)calloc((size_t)c->bw * 8 * (size_t)c->bh * 8, 1);
    if (!c->plane) return fail(d, "out of memory");
  }
  return 0;
}

static int decode_block(dec_t *d, bits_t *b, comp_t *c, int16_t *blk) {
  int s, r;
  memset(blk, 0, 64 * sizeof(int16_t));
  s = decode_symbol(b, &d->dc[c->td]);
  if (s < 0 || s > 15) return fail(d, "corrupt entropy-coded data (DC)");
  if (s) s = extend(get_bits(b, s), s);
  c->pred += s;
  blk[0] = (int16_t)c->pred;
  for (int k = 1; k < 64; k++) {
    s = decode_symbol(b, &d->ac[c->ta]);
    if (s < 0) return fail(d, "corrupt entropy-coded data (AC)");
    r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      s = extend(get_bits(b, s), s);
      blk[natural_order[k]] = (int16_t)s;
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return 0;
}

/* Skip to the next marker (at an RSTn after an interval's padding bits). */
static const uint8_t *next_marker(const uint8_t *p, const uint8_t *end) {
  while (p + 1 < end) {
    if (p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF) return p;
    p++;
  }
  return end;
}

static int read_scan(dec_t *d, const uint8_t *p, int len, const uint8_t *end, const uint8_t **after) {
  comp_t *sc[3];
  int ns, ss, se, ah, al, mcus_x, mcus_y, restarts_left, next_rst = 0;
  bits_t b;
  int16_t blk[64];

  if (!d->saw_frame) return fail(d, "SOS before a frame header");
  if (len < 1) return fail(d, "SOS: truncated segment");
  ns = p[0];
  if (ns < 1 || ns > d->ncomp || len < 4 + 2 * ns) return fail(d, "SOS: %d components", ns);
  for (int i = 0; i < ns; i++) {
    int id = p[1 + 2 * i], j;
    for (j = 0; j < d->ncomp && d->comp[j].id != id; j++) {}
    if (j == d->ncomp) return fail(d, "SOS: unknown component %d", id);
    sc[i] = &d->comp[j];
    sc[i]->td = p[2 + 2 * i] >> 4;
    sc[i]->ta = p[2 + 2 * i] & 15;
    if (sc[i]->td > 3 || sc[i]->ta > 3 || !d->dc[sc[i]->td].defined || !d->ac[sc[i]->ta].defined)
      return fail(d, "SOS: undefined Huffman table");
    if (!d->qt_defined[sc[i]->tq]) return fail(d, "SOS: undefined quantization table %d", sc[i]->tq);
    sc[i]->pred = 0;
  }
  ss = p[1 + 2 * ns];
  se = p[2 + 2 * ns];
  ah = p[3 + 2 * ns] >> 4;
  al = p[3 + 2 * ns] & 15;
  if (ss != 0 || se != 63 || ah != 0 || al != 0) return fail(d, "SOS: spectral selection of a progressive scan");

  if (ns == 1) {  /* non-interleaved: one block per MCU over the component's own area */
    mcus_x = (sc[0]->dw + 7) / 8;
    mcus_y = (sc[0]->dh + 7) / 8;
  } else {
    mcus_x = d->mcux;
    mcus_y = d->mcuy;
  }
  memset(&b, 0, sizeof(b));
  b.p = p + len;
  b.end = end;
  restarts_left = d->restart_interval;

  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (d->restart_interval && restarts_left == 0) {
        const uint8_t *m = next_marker(b.p, end);
        if (m + 1 >= end || m[1] != 0xD0 + next_rst)
          return fail(d, "expected restart marker RST%d", next_rst);
        b.p = m + 2;
        b.acc = 0;
        b.nbits = 0;
        b.at_marker = 0;
        next_rst = (next_rst + 1) & 7;
        restarts_left = d->restart_interval;
        for (int i = 0; i < ns; i++) sc[i]->pred = 0;
      }
      for (int i = 0; i < ns; i++) {
        comp_t *c = sc[i];
        int bh = ns == 1 ? 1 : c->v, bw = ns == 1 ? 1 : c->h;
        int stride = c->bw * 8;
        for (int by = 0; by < bh; by++) {
          for (int bx = 0; bx < bw; bx++) {
            int row = (my * bh + by) * 8, col = (mx * bw + bx) * 8;
            if (decode_block(d, &b, c, blk)) return -1;
            idct_islow(blk, d->qt[c->tq], c->plane + (size_t)row * stride + col, stride);
          }
        }
      }
      if (d->restart_interval) restarts_left--;
    }
  }
  *after = next_marker(b.p, end);
  return 0;
}

/* -- upsampling (jdsample.c, fancy) and color conversion (jdcolor.c) -------- */

/* One component's full-resolution samples, (height rounded up to even) x
 * (width rounded up to even), from its plane. */
static int upsample(dec_t *d, comp_t *c, uint8_t **out) {
  int hr = d->hmax / c->h, vr = d->vmax / c->v;
  int ow = c->dw * hr, oh = c->dh * vr, stride = c->bw * 8;
  uint8_t *o;
  if (hr == 1 && vr == 1) {
    *out = NULL;   /* use the plane itself */
    return 0;
  }
  o = (uint8_t *)malloc((size_t)ow * oh);
  if (!o) return fail(d, "out of memory");
  for (int y = 0; y < oh; y++) {
    int iy = y / vr;
    const uint8_t *in0 = c->plane + (size_t)iy * stride, *in1 = in0;
    uint8_t *op = o + (size_t)y * ow;
    int bias = 1;
    if (vr == 2) {
      if ((y & 1) == 0) {  /* the row above is the next nearest */
        in1 = c->plane + (size_t)(iy > 0 ? iy - 1 : 0) * stride;
        bias = 1;
      } else {
        in1 = c->plane + (size_t)(iy + 1 < c->dh ? iy + 1 : c->dh - 1) * stride;
        bias = 2;
      }
    }
    if (hr == 1) {  /* h1v2 */
      for (int x = 0; x < c->dw; x++) op[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    } else if (c->dw <= 2) {  /* too narrow to filter: libjpeg replicates (box) */
      for (int x = 0; x < c->dw; x++) op[2 * x] = op[2 * x + 1] = in0[x];
    } else if (vr == 1) {  /* h2v1 */
      int w = c->dw;
      op[0] = in0[0];
      op[1] = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
      for (int x = 1; x < w - 1; x++) {
        int v = in0[x] * 3;
        op[2 * x] = (uint8_t)((v + in0[x - 1] + 1) >> 2);
        op[2 * x + 1] = (uint8_t)((v + in0[x + 1] + 2) >> 2);
      }
      op[2 * w - 2] = (uint8_t)((in0[w - 1] * 3 + in0[w - 2] + 1) >> 2);
      op[2 * w - 1] = in0[w - 1];
    } else {  /* h2v2 */
      int w = c->dw, last, cur, next;
      cur = in0[0] * 3 + in1[0];
      next = in0[1] * 3 + in1[1];
      op[0] = (uint8_t)((cur * 4 + 8) >> 4);
      op[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
      last = cur;
      cur = next;
      for (int x = 1; x < w - 1; x++) {
        next = in0[x + 1] * 3 + in1[x + 1];
        op[2 * x] = (uint8_t)((cur * 3 + last + 8) >> 4);
        op[2 * x + 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
      }
      op[2 * w - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
      op[2 * w - 1] = (uint8_t)((cur * 4 + 7) >> 4);
    }
  }
  *out = o;
  return 0;
}

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static inline uint8_t clamp255(int x) { return (uint8_t)(x < 0 ? 0 : x > 255 ? 255 : x); }

static int finish(dec_t *d, uint8_t *rgb) {
  uint8_t *full[3] = {NULL, NULL, NULL};
  const uint8_t *src[3];
  int stride[3];
  int rc = 0;
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    if (upsample(d, c, &full[i])) { rc = -1; goto done; }
    src[i] = full[i] ? full[i] : c->plane;
    stride[i] = full[i] ? c->dw * (d->hmax / c->h) : c->bw * 8;
  }
  if (d->ncomp == 1) {
    for (int y = 0; y < d->height; y++) {
      const uint8_t *s = src[0] + (size_t)y * stride[0];
      uint8_t *o = rgb + (size_t)y * d->width * 3;
      for (int x = 0; x < d->width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = s[x];
    }
  } else {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    for (int yy = 0; yy < d->height; yy++) {
      const uint8_t *ys = src[0] + (size_t)yy * stride[0];
      const uint8_t *cbs = src[1] + (size_t)yy * stride[1];
      const uint8_t *crs = src[2] + (size_t)yy * stride[2];
      uint8_t *o = rgb + (size_t)yy * d->width * 3;
      for (int x = 0; x < d->width; x++) {
        int y = ys[x], cb = cbs[x], cr = crs[x];
        o[3 * x] = clamp255(y + cr_r[cr]);
        o[3 * x + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        o[3 * x + 2] = clamp255(y + cb_b[cb]);
      }
    }
  }
done:
  for (int i = 0; i < 3; i++) free(full[i]);
  return rc;
}

/* -- markers -------------------------------------------------------------- */

static const char *sof_name(int m) {
  switch (m) {
    case 0xC2: return "SOF2 (progressive DCT)";
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC9: return "SOF9 (arithmetic sequential)";
    case 0xCA: return "SOF10 (arithmetic progressive)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
    default: return NULL;
  }
}

/* Walks the markers; with `rgb` NULL stops after the frame header. */
static int run(dec_t *d, const uint8_t *data, long size, uint8_t *rgb) {
  const uint8_t *p = data, *end = data + size;
  if (size < 4 || p[0] != 0xFF || p[1] != 0xD8) return fail(d, "not a JPEG file (no SOI marker)");
  p += 2;
  for (;;) {
    int marker, len;
    while (p < end && *p != 0xFF) p++;   /* tolerate junk between segments */
    while (p < end && *p == 0xFF) p++;   /* fill bytes */
    if (p >= end) return fail(d, "truncated file (no EOI marker)");
    marker = *p++;
    if (marker == 0xD9) break;                        /* EOI */
    if (marker >= 0xD0 && marker <= 0xD7) continue;   /* a stray RSTn */
    if (marker == 0x01) continue;                     /* TEM */
    if (p + 2 > end) return fail(d, "truncated marker segment");
    len = read_u16(p) - 2;
    if (len < 0 || p + 2 + len > end) return fail(d, "truncated marker segment 0x%02X", marker);
    p += 2;
    if (marker == 0xC0 || marker == 0xC1) {
      if (read_sof(d, p, len)) return -1;
      if (!rgb) return 0;
      if (alloc_planes(d)) return -1;
    } else if (sof_name(marker)) {
      return refuse(d, "%s is not supported (baseline and extended sequential Huffman only)", sof_name(marker));
    } else if (marker == 0xCC) {
      return refuse(d, "DAC (arithmetic coding) is not supported");
    } else if (marker == 0xC4) {
      if (read_dht(d, p, len)) return -1;
    } else if (marker == 0xDB) {
      if (read_dqt(d, p, len)) return -1;
    } else if (marker == 0xDD) {
      if (len < 2) return fail(d, "DRI: truncated segment");
      d->restart_interval = read_u16(p);
    } else if (marker == 0xDA) {
      const uint8_t *after;
      if (!rgb) return fail(d, "SOS before a frame header");
      if (d->ncomp == 3) {
        /* libjpeg's choice of color space (jdapimin.c default_decompress_parms) */
        if (!d->saw_jfif && d->adobe_transform == 0)
          return refuse(d, "APP14 (Adobe) transform 0: RGB-coded JPEG is not supported");
        if (!d->saw_jfif && d->adobe_transform < 0 && d->comp[0].id == 'R' && d->comp[1].id == 'G' &&
            d->comp[2].id == 'B')
          return refuse(d, "SOF: components R, G, B (RGB-coded JPEG) are not supported");
      }
      if (read_scan(d, p, len, end, &after)) return -1;
      p = after;
      continue;
    } else if (marker == 0xE0) {
      if (len >= 5 && memcmp(p, "JFIF\0", 5) == 0) d->saw_jfif = 1;
    } else if (marker == 0xEE) {
      if (len >= 12 && memcmp(p, "Adobe", 5) == 0) d->adobe_transform = p[11];
    } else if (marker == 0xDC) {
      return refuse(d, "DNL is not supported");
    }
    /* other APPn, COM: skipped */
    p += len;
  }
  if (!d->saw_frame) return fail(d, "no frame header (SOF) before EOI");
  if (!rgb) return 0;
  return finish(d, rgb);
}

static void init(dec_t *d, char *err, int err_size) {
  memset(d, 0, sizeof(*d));
  d->adobe_transform = -1;
  d->err = err;
  d->err_size = err_size;
  if (err && err_size > 0) err[0] = 0;
}

int jpeg_header(const uint8_t *data, long size, int *width, int *height, int *components, char *err,
                int err_size) {
  dec_t d;
  int rc;
  init(&d, err, err_size);
  rc = run(&d, data, size, NULL);
  if (rc && d.unsupported) rc = -2;
  if (rc == 0) {
    *width = d.width;
    *height = d.height;
    *components = d.ncomp;
  }
  return rc;
}

int jpeg_decode(const uint8_t *data, long size, uint8_t *rgb, int width, int height, char *err,
                int err_size) {
  dec_t d;
  int rc;
  init(&d, err, err_size);
  rc = run(&d, data, size, rgb);
  if (rc == 0 && (d.width != width || d.height != height))
    rc = fail(&d, "image is %dx%d, the buffer %dx%d", d.width, d.height, width, height);
  if (rc && d.unsupported) rc = -2;
  for (int i = 0; i < 3; i++) free(d.comp[i].plane);
  return rc;
}
