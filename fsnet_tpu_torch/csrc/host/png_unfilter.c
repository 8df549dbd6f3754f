/* Reverses the scanline filters of a non-interlaced PNG (PNG specification,
 * section 9: None, Sub, Up, Average, Paeth) on the host.
 *
 * src holds the inflated image data: height rows, each a filter-type byte
 * followed by rowbytes filtered bytes. dst receives height * rowbytes
 * reconstructed bytes. bpp is the distance in bytes to the corresponding
 * byte of the pixel to the left (channels times bytes per sample, at least
 * 1). Average and Paeth read the reconstructed byte to the left and the one
 * above, so each row is a serial scan.
 *
 * Returns 0, or -(r + 1) where row r carries a filter type above 4.
 */
#include <stdint.h>
#include <stdlib.h>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

int64_t png_unfilter(const uint8_t *src, uint8_t *dst, int64_t height,
                     int64_t rowbytes, int64_t bpp) {
    for (int64_t r = 0; r < height; ++r) {
        const uint8_t type = src[r * (rowbytes + 1)];
        const uint8_t *in = src + r * (rowbytes + 1) + 1;
        uint8_t *out = dst + r * rowbytes;
        const uint8_t *up = r > 0 ? out - rowbytes : NULL;
        int64_t i;
        switch (type) {
        case 0:
            for (i = 0; i < rowbytes; ++i) out[i] = in[i];
            break;
        case 1:
            for (i = 0; i < bpp && i < rowbytes; ++i) out[i] = in[i];
            for (; i < rowbytes; ++i) out[i] = (uint8_t)(in[i] + out[i - bpp]);
            break;
        case 2:
            if (up)
                for (i = 0; i < rowbytes; ++i) out[i] = (uint8_t)(in[i] + up[i]);
            else
                for (i = 0; i < rowbytes; ++i) out[i] = in[i];
            break;
        case 3:
            for (i = 0; i < rowbytes; ++i) {
                int left = i >= bpp ? out[i - bpp] : 0;
                int above = up ? up[i] : 0;
                out[i] = (uint8_t)(in[i] + ((left + above) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < rowbytes; ++i) {
                int left = i >= bpp ? out[i - bpp] : 0;
                int above = up ? up[i] : 0;
                int corner = (up && i >= bpp) ? up[i - bpp] : 0;
                out[i] = (uint8_t)(in[i] + paeth(left, above, corner));
            }
            break;
        default:
            return -(r + 1);
        }
    }
    return 0;
}
