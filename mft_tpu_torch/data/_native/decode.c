/* Native decode pipeline: libjpeg draft-scaled JPEG decode + a bit-exact
 * reimplementation of PIL's fixed-point antialiased bilinear resample,
 * with an in-library pthread batch API (decode scales with cores, no GIL).
 *
 * The port's own copy of the JAX package's mft_tpu/data/_native/decode.c,
 * with the same C ABI (mft_abi_version 1).  The reference's loader is
 * torch's native DataLoader machinery + PIL's C decode path (reference
 * data/datamgr.py:50-62, datasets/CropDisease_few_shot.py:112-124).  The
 * Python contract is mft_tpu_torch/data/pipeline.py:decode_image —
 * squash-resize to [base, base, 3] uint8 after an optional DCT-domain draft
 * downscale — and the output here is required to be BIT-IDENTICAL to that
 * PIL path (enforced at runtime by a canary check in native_decode.py and
 * by tests/test_torch_native_decode.py), so the pixel-exact clean view is
 * preserved regardless of backend.
 *
 * Draft scaling mirrors PIL's JpegImagePlugin.draft: the largest scale
 * s in {8,4,2,1} with min(w//tw, h//th) >= s, decoded at scale_num/denom =
 * 1/s (output ceil(w/s) x ceil(h/s), exactly PIL's (w+s-1)//s), normal
 * islow DCT + fancy upsampling (PIL's decoderconfig draft-quality flag is
 * 0 on this path, so PIL keeps them too).
 *
 * The resample reproduces PIL Resample.c for the BILINEAR (triangle)
 * filter: double-precision normalized coefficients quantized to
 * INT32 << PRECISION_BITS, horizontal pass to a uint8 intermediate, then
 * the vertical pass — including the per-pass uint8 rounding, so results
 * match PIL bit for bit rather than merely closely. */

#include <stddef.h>
#include <stdio.h>

#include <jpeglib.h> /* must come after stdio/stddef: its prototypes use FILE/size_t */

#include <math.h>
#include <pthread.h>
#include <setjmp.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------------------------------------------------------------- errors */

struct err_mgr {
    struct jpeg_error_mgr pub;
    jmp_buf jump;
};

static void err_exit(j_common_ptr cinfo) {
    struct err_mgr *err = (struct err_mgr *)cinfo->err;
    longjmp(err->jump, 1);
}

static void err_silent(j_common_ptr cinfo) { (void)cinfo; }

/* ------------------------------------------------- PIL-exact resampling */

#define PRECISION_BITS (32 - 8 - 2)

static inline uint8_t clip8(int32_t in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

static double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    if (x < 1.0) return 1.0 - x;
    return 0.0;
}

/* PIL precompute_coeffs + normalize_coeffs_8bpc for the triangle filter.
 * Returns ksize; fills bounds[2*out] (xmin, xmax-count) and kk[out*ksize]. */
static int precompute_coeffs(int in_size, int out_size, int **bounds_out, int32_t **kk_out) {
    double support, scale, filterscale, center, ww, ss;
    int xx, x, xmin, xmax, ksize;
    double *w;
    int *bounds;
    int32_t *kk;

    scale = filterscale = (double)in_size / out_size;
    if (filterscale < 1.0) filterscale = 1.0;
    support = 1.0 * filterscale; /* bilinear support = 1.0 */
    ksize = (int)ceil(support) * 2 + 1;

    w = malloc(sizeof(double) * ksize);
    bounds = malloc(sizeof(int) * out_size * 2);
    kk = malloc(sizeof(int32_t) * out_size * ksize);
    if (!w || !bounds || !kk) {
        free(w); free(bounds); free(kk);
        return -1;
    }
    ss = 1.0 / filterscale;
    for (xx = 0; xx < out_size; xx++) {
        center = (xx + 0.5) * scale;
        ww = 0.0;
        xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        for (x = 0; x < xmax; x++) {
            double v = bilinear_filter((x + xmin - center + 0.5) * ss);
            w[x] = v;
            ww += v;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) w[x] /= ww;
        }
        for (x = 0; x < xmax; x++) {
            double v = w[x] * (1 << PRECISION_BITS);
            kk[xx * ksize + x] = (int32_t)(v < 0 ? v - 0.5 : v + 0.5);
        }
        for (; x < ksize; x++) kk[xx * ksize + x] = 0;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    free(w);
    *bounds_out = bounds;
    *kk_out = kk;
    return ksize;
}

/* Two-pass (horizontal then vertical, uint8 intermediate) RGB resample,
 * PIL ImagingResample order and math. Returns 0 on success. */
static int resample_rgb(const uint8_t *in, int in_w, int in_h, uint8_t *out, int out_w, int out_h) {
    int *xb = NULL, *yb = NULL;
    int32_t *xk = NULL, *yk = NULL;
    int xks, yks, y, xx, c;
    uint8_t *mid = NULL;
    int rc = -1;

    if (in_w == out_w && in_h == out_h) {
        memcpy(out, in, (size_t)in_w * in_h * 3);
        return 0;
    }
    xks = precompute_coeffs(in_w, out_w, &xb, &xk);
    if (xks < 0) goto done;
    yks = precompute_coeffs(in_h, out_h, &yb, &yk);
    if (yks < 0) goto done;

    mid = malloc((size_t)out_w * in_h * 3);
    if (!mid) goto done;

    if (in_w != out_w) {
        for (y = 0; y < in_h; y++) {
            const uint8_t *row = in + (size_t)y * in_w * 3;
            uint8_t *orow = mid + (size_t)y * out_w * 3;
            for (xx = 0; xx < out_w; xx++) {
                int xmin = xb[xx * 2 + 0], xmax = xb[xx * 2 + 1];
                const int32_t *k = &xk[xx * xks];
                for (c = 0; c < 3; c++) {
                    int32_t ss0 = 1 << (PRECISION_BITS - 1);
                    int x;
                    for (x = 0; x < xmax; x++)
                        ss0 += row[(x + xmin) * 3 + c] * k[x];
                    orow[xx * 3 + c] = clip8(ss0);
                }
            }
        }
    } else {
        memcpy(mid, in, (size_t)in_w * in_h * 3);
    }

    if (in_h != out_h) {
        for (y = 0; y < out_h; y++) {
            int ymin = yb[y * 2 + 0], ymax = yb[y * 2 + 1];
            const int32_t *k = &yk[y * yks];
            uint8_t *orow = out + (size_t)y * out_w * 3;
            for (xx = 0; xx < out_w; xx++) {
                for (c = 0; c < 3; c++) {
                    int32_t ss0 = 1 << (PRECISION_BITS - 1);
                    int yy;
                    for (yy = 0; yy < ymax; yy++)
                        ss0 += mid[((size_t)(yy + ymin) * out_w + xx) * 3 + c] * k[yy];
                    orow[xx * 3 + c] = clip8(ss0);
                }
            }
        }
    } else {
        memcpy(out, mid, (size_t)out_w * out_h * 3);
    }
    rc = 0;
done:
    free(xb); free(yb); free(xk); free(yk); free(mid);
    return rc;
}

/* ------------------------------------------------------------ decoding */

/* status codes */
#define MFT_OK 0
#define MFT_ERR_DECODE 1
#define MFT_ERR_NOT_JPEG 2   /* caller should fall back (e.g. PNG via PIL) */
#define MFT_ERR_IO 3
#define MFT_ERR_UNSUPPORTED 4 /* e.g. CMYK: PIL's conversion is the oracle */
#define MFT_ERR_TRUNCATED 5   /* damaged stream: pixels would be backend-defined */

/* Decode one in-memory JPEG to out[base*base*3] uint8. */
int mft_decode_jpeg(const uint8_t *data, size_t len, int base_size, int draft, uint8_t *out) {
    struct jpeg_decompress_struct cinfo;
    struct err_mgr jerr;
    /* volatile: modified between setjmp and longjmp and read in the
     * handler (C99 7.13.2.1) — without it free(raw) after longjmp may see
     * a register-restored stale value */
    uint8_t *volatile raw = NULL;
    int rc = MFT_ERR_DECODE;

    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) return MFT_ERR_NOT_JPEG;
    if (base_size <= 0) return MFT_ERR_UNSUPPORTED;

    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = err_exit;
    jerr.pub.output_message = err_silent; /* no stderr spam from worker threads */
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        free(raw);
        return MFT_ERR_DECODE;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, (unsigned char *)data, (unsigned long)len);
    jpeg_read_header(&cinfo, TRUE);

    if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK ||
        cinfo.num_components == 4) {
        jpeg_destroy_decompress(&cinfo);
        return MFT_ERR_UNSUPPORTED;
    }
    cinfo.out_color_space = JCS_RGB;

    if (draft) {
        /* PIL JpegImagePlugin.draft: largest s in {8,4,2,1} with
         * min(w//tw, h//th) >= s; scale 1/s keeps islow + fancy upsampling
         * (the PIL path's draft-quality flag is 0). */
        int m_w = (int)(cinfo.image_width / (unsigned)base_size);
        int m_h = (int)(cinfo.image_height / (unsigned)base_size);
        int m = m_w < m_h ? m_w : m_h;
        int s = (m >= 8) ? 8 : (m >= 4) ? 4 : (m >= 2) ? 2 : 1;
        cinfo.scale_num = 1;
        cinfo.scale_denom = (unsigned)s;
    }

    jpeg_start_decompress(&cinfo);
    {
        int w = (int)cinfo.output_width, h = (int)cinfo.output_height;
        size_t stride = (size_t)w * 3;
        raw = malloc(stride * h);
        if (!raw) {
            jpeg_destroy_decompress(&cinfo);
            return MFT_ERR_DECODE;
        }
        /* Tolerate truncated streams the way PIL's LOAD_TRUNCATED_IMAGES
         * does: libjpeg's mem source fakes an EOI at buffer end (with a
         * warning) and keeps producing rows. */
        while (cinfo.output_scanline < cinfo.output_height) {
            JSAMPROW rowp = raw + stride * cinfo.output_scanline;
            jpeg_read_scanlines(&cinfo, &rowp, 1);
        }
        jpeg_finish_decompress(&cinfo);
        /* A damaged stream (truncated / corrupt entropy) decodes "successfully"
         * via the fake-EOI tolerance, but the pixels libjpeg synthesizes for
         * the missing region are backend-defined — NOT bit-identical to PIL's.
         * The shared episode cache key deliberately excludes the decode
         * backend on bit-identity grounds, so such files must NOT be produced
         * here: any accumulated warning demotes the result to
         * MFT_ERR_TRUNCATED and the caller decodes that file via PIL. */
        if (cinfo.err->num_warnings != 0) {
            jpeg_destroy_decompress(&cinfo);
            free(raw);
            return MFT_ERR_TRUNCATED;
        }
        jpeg_destroy_decompress(&cinfo);
        rc = resample_rgb(raw, w, h, out, base_size, base_size) == 0 ? MFT_OK : MFT_ERR_DECODE;
        free(raw);
        raw = NULL;
    }
    return rc;
}

/* Decode one JPEG file from disk. */
int mft_decode_jpeg_file(const char *path, int base_size, int draft, uint8_t *out) {
    FILE *f = fopen(path, "rb");
    uint8_t *buf;
    long n;
    size_t got;
    int rc;

    if (!f) return MFT_ERR_IO;
    if (fseek(f, 0, SEEK_END) != 0 || (n = ftell(f)) < 0 || fseek(f, 0, SEEK_SET) != 0) {
        fclose(f);
        return MFT_ERR_IO;
    }
    buf = malloc((size_t)n);
    if (!buf) {
        fclose(f);
        return MFT_ERR_IO;
    }
    /* pass the bytes actually read: a short read (file shrank / IO error)
     * must look like a truncated stream (fake-EOI tolerance), not hand the
     * decoder uninitialized heap as entropy data */
    got = fread(buf, 1, (size_t)n, f);
    fclose(f);
    rc = mft_decode_jpeg(buf, got, base_size, draft, out);
    free(buf);
    return rc;
}

/* --------------------------------------------------------- batch pthreads */

typedef struct {
    const char **paths;
    int n;
    int base_size;
    int draft;
    uint8_t *out; /* n * base*base*3 */
    int *status;  /* n */
    int next;
    pthread_mutex_t lock;
} batch_t;

static void *batch_worker(void *arg) {
    batch_t *b = (batch_t *)arg;
    size_t img = (size_t)b->base_size * b->base_size * 3;
    for (;;) {
        int i;
        pthread_mutex_lock(&b->lock);
        i = b->next < b->n ? b->next++ : -1;
        pthread_mutex_unlock(&b->lock);
        if (i < 0) break;
        b->status[i] = mft_decode_jpeg_file(b->paths[i], b->base_size, b->draft, b->out + img * i);
    }
    return NULL;
}

/* Decode n files in parallel on an internal thread pool.  out must hold
 * n*base*base*3 bytes; status[i] receives a MFT_* code per file (nonzero
 * entries are the caller's cue to fall back to the PIL path for that
 * file).  Returns the number of failures. */
int mft_decode_batch(const char **paths, int n, int base_size, int draft, int n_threads,
                     uint8_t *out, int *status) {
    batch_t b = {paths, n, base_size, draft, out, status, 0, PTHREAD_MUTEX_INITIALIZER};
    pthread_t tids[64];
    int i, fails = 0;

    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    if (n_threads > n) n_threads = n;

    if (n_threads <= 1) {
        batch_worker(&b);
    } else {
        int started = 0;
        for (i = 0; i < n_threads; i++) {
            if (pthread_create(&tids[i], NULL, batch_worker, &b) != 0) break;
            started++;
        }
        if (started == 0) batch_worker(&b); /* thread creation failed: run inline */
        for (i = 0; i < started; i++) pthread_join(tids[i], NULL);
    }
    for (i = 0; i < n; i++)
        if (status[i] != MFT_OK) fails++;
    return fails;
}

/* Standalone resample entry (for tests): RGB uint8 in -> out. */
int mft_resample_rgb(const uint8_t *in, int in_w, int in_h, uint8_t *out, int out_w, int out_h) {
    return resample_rgb(in, in_w, in_h, out, out_w, out_h);
}

int mft_abi_version(void) { return 1; }
