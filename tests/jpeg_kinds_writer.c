/* Writes one JPEG with libjpeg(-turbo), in the kinds PIL cannot write:
 * arithmetic coding (SOF9, or SOF10 with jpeg_simple_progression), its
 * DAC conditioning, and four-component CMYK / YCCK files.
 *
 *   jpeg_kinds_writer in.raw width height components out.jpg [key=value ...]
 *
 * in.raw holds width*height*components bytes, row by row: grey (1), RGB
 * (3) or CMYK (4). Keys (all optional):
 *   quality=N        1-100 (default 90)
 *   sampling=S       444, 422 or 420 for the first component (default 420)
 *   arith=0|1        arithmetic coding (default 1)
 *   progressive=0|1  jpeg_simple_progression (default 0)
 *   restart_rows=N   a restart marker every N MCU rows (default 0)
 *   dc_L=N dc_U=N    DC conditioning bounds of table 0 (defaults 0, 1)
 *   ac_K=N           AC conditioning Kx of table 0 (default 5)
 *   ycck=0|1         with 4 components: write YCCK (Adobe transform 2)
 *                    instead of CMYK (transform 0)
 *
 * Build: gcc -O2 jpeg_kinds_writer.c -ljpeg (needs jpeglib.h).
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static int option(int argc, char** argv, const char* key, int fallback) {
  size_t n = strlen(key);
  for (int i = 6; i < argc; ++i)
    if (strncmp(argv[i], key, n) == 0 && argv[i][n] == '=') return atoi(argv[i] + n + 1);
  return fallback;
}

int main(int argc, char** argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s in.raw width height components out.jpg [key=value ...]\n", argv[0]);
    return 2;
  }
  int width = atoi(argv[2]), height = atoi(argv[3]), nc = atoi(argv[4]);
  size_t row = (size_t)width * nc, size = row * height;
  unsigned char* pixels = malloc(size);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(pixels, 1, size, in) != size) {
    fprintf(stderr, "cannot read %zu bytes from %s\n", size, argv[1]);
    return 1;
  }
  fclose(in);
  FILE* out = fopen(argv[5], "wb");
  if (!out) {
    fprintf(stderr, "cannot write %s\n", argv[5]);
    return 1;
  }

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = nc;
  cinfo.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  if (nc == 4 && option(argc, argv, "ycck", 0)) jpeg_set_colorspace(&cinfo, JCS_YCCK);
  jpeg_set_quality(&cinfo, option(argc, argv, "quality", 90), TRUE);
  int sampling = option(argc, argv, "sampling", 420);
  cinfo.comp_info[0].h_samp_factor = sampling == 444 ? 1 : 2;
  cinfo.comp_info[0].v_samp_factor = sampling == 420 ? 2 : 1;
  if (nc == 4) {  /* K at the luma's sampling, as libjpeg's YCCK default */
    cinfo.comp_info[3].h_samp_factor = cinfo.comp_info[0].h_samp_factor;
    cinfo.comp_info[3].v_samp_factor = cinfo.comp_info[0].v_samp_factor;
  }
  cinfo.arith_code = option(argc, argv, "arith", 1) ? TRUE : FALSE;
  cinfo.arith_dc_L[0] = (UINT8)option(argc, argv, "dc_L", 0);
  cinfo.arith_dc_U[0] = (UINT8)option(argc, argv, "dc_U", 1);
  cinfo.arith_ac_K[0] = (UINT8)option(argc, argv, "ac_K", 5);
  cinfo.restart_in_rows = option(argc, argv, "restart_rows", 0);
  if (option(argc, argv, "progressive", 0)) jpeg_simple_progression(&cinfo);

  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW r = pixels + row * cinfo.next_scanline;
    jpeg_write_scanlines(&cinfo, &r, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(pixels);
  return 0;
}
