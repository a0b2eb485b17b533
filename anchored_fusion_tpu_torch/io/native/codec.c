/* Native host-side sequence codec.
 *
 * The reference delegates all byte-level work (FASTQ parsing, base encoding)
 * to bwa/samtools C code through pipes; this is the framework's in-process
 * equivalent: a small C library that turns FASTQ and raw DNA byte buffers
 * into the packed int8 code arrays the device kernels consume.  Compiled on
 * first use with the system toolchain (see loader in __init__.py); the
 * pure-Python parser remains for a machine without a C compiler.
 *
 * Code space must match ops/encode.py: A=0, C=1, G=2, T=3, N=4, PAD=5.
 */

#include <stdint.h>
#include <string.h>

static signed char LUT[256];
static int lut_ready = 0;

static void init_lut(void) {
    if (lut_ready) return;
    memset(LUT, 4, sizeof(LUT)); /* everything unknown -> N */
    LUT['A'] = 0; LUT['a'] = 0;
    LUT['C'] = 1; LUT['c'] = 1;
    LUT['G'] = 2; LUT['g'] = 2;
    LUT['T'] = 3; LUT['t'] = 3;
    lut_ready = 1;
}

/* Encode a raw DNA byte string into int8 codes. Returns n. */
long aft_encode_dna(const char *buf, long n, signed char *out) {
    init_lut();
    for (long i = 0; i < n; i++) out[i] = LUT[(unsigned char)buf[i]];
    return n;
}

/* Parse a FASTQ buffer.
 *
 * out:      n_max * stride int8 array, pre-filled by caller with PAD(5)
 * lens:     n_max int32 read lengths
 * name_off: n_max int64 offsets of read names in buf
 * name_len: n_max int32 name lengths (up to first space/tab, no /1 /2 strip)
 *
 * Returns the number of records parsed (< 0 on malformed input).
 */
long aft_decode_fastq(const char *buf, long buflen, signed char *out,
                      int stride, int *lens, long *name_off, int *name_len,
                      long n_max) {
    init_lut();
    long i = 0, n = 0;
    while (i < buflen && n < n_max) {
        if (buf[i] != '@') return -1;
        long h = ++i; /* name start */
        while (i < buflen && buf[i] != '\n') i++;
        long he = h;
        while (he < i && buf[he] != ' ' && buf[he] != '\t') he++;
        name_off[n] = h;
        name_len[n] = (int)(he - h);
        i++; /* sequence line */
        long s = i;
        while (i < buflen && buf[i] != '\n') i++;
        long sl = i - s;
        if (sl > stride) sl = stride;
        signed char *dst = out + n * (long)stride;
        for (long k = 0; k < sl; k++) dst[k] = LUT[(unsigned char)buf[s + k]];
        lens[n] = (int)sl;
        i++; /* '+' line */
        while (i < buflen && buf[i] != '\n') i++;
        i++; /* quality line */
        while (i < buflen && buf[i] != '\n') i++;
        i++;
        n++;
    }
    return n;
}

/* Longest sequence-line length in a FASTQ buffer (for width sizing). */
long aft_fastq_max_len(const char *buf, long buflen) {
    long i = 0, best = 0;
    while (i < buflen) {
        while (i < buflen && buf[i] != '\n') i++; i++;      /* header */
        long s = i;
        while (i < buflen && buf[i] != '\n') i++;
        if (i - s > best) best = i - s;
        i++;
        while (i < buflen && buf[i] != '\n') i++; i++;      /* '+' */
        while (i < buflen && buf[i] != '\n') i++; i++;      /* qual */
    }
    return best;
}

/* Count FASTQ records. */
long aft_fastq_count(const char *buf, long buflen) {
    long i = 0, n = 0;
    while (i < buflen) {
        int line = 0;
        for (line = 0; line < 4 && i < buflen; line++) {
            while (i < buflen && buf[i] != '\n') i++;
            i++;
        }
        if (line == 4) n++;
    }
    return n;
}
