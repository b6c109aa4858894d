// Native P3 PPM encoder.
//
// The reference emits its image as text PPM from the render driver
// (reference: src/gpu/camera.h:197-210 `output_image`,
// src/cpu/main.cc:109-121). Text-formatting a 1920x1080 frame through a
// Python loop costs tens of milliseconds of interpreter time per frame;
// this encoder is a single pass over the pixel buffer with a
// precomputed decimal-string table, bound into utils/ppm.py via ctypes.
//
// Build: native/build.sh  ->  native/build/libppm_encoder.so (or on first use)

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// dec[v] = decimal digits of v, len[v] = digit count, for v in [0, 255].
struct DecTable {
  char digits[256][3];
  uint8_t len[256];
  DecTable() {
    for (int v = 0; v < 256; ++v) {
      if (v >= 100) {
        digits[v][0] = static_cast<char>('0' + v / 100);
        digits[v][1] = static_cast<char>('0' + (v / 10) % 10);
        digits[v][2] = static_cast<char>('0' + v % 10);
        len[v] = 3;
      } else if (v >= 10) {
        digits[v][0] = static_cast<char>('0' + v / 10);
        digits[v][1] = static_cast<char>('0' + v % 10);
        len[v] = 2;
      } else {
        digits[v][0] = static_cast<char>('0' + v);
        len[v] = 1;
      }
    }
  }
};

const DecTable kDec;

inline char* put_u8(char* p, uint8_t v) {
  std::memcpy(p, kDec.digits[v], 3);  // always copy 3, advance by len
  return p + kDec.len[v];
}

}  // namespace

extern "C" {

// Encodes [h, w, 3] uint8 pixels (row-major, top row first) as P3 text:
//   P3\n{w} {h}\n255\n
//   r g b\n  (one triplet per line, matching utils/ppm.py's fallback)
// Returns bytes written, or -1 if `cap` is too small.
long long ppm_encode_p3(const uint8_t* pixels, int w, int h, char* out,
                        long long cap) {
  // Worst case per pixel: "255 255 255\n" = 12 bytes; header < 64.
  const long long need = 12LL * w * h + 64;
  if (cap < need) return -1;

  char* p = out;
  p += std::sprintf(p, "P3\n%d %d\n255\n", w, h);

  const uint8_t* px = pixels;
  const long long n = static_cast<long long>(w) * h;
  for (long long i = 0; i < n; ++i) {
    p = put_u8(p, px[0]);
    *p++ = ' ';
    p = put_u8(p, px[1]);
    *p++ = ' ';
    p = put_u8(p, px[2]);
    *p++ = '\n';
    px += 3;
  }
  return p - out;
}

}  // extern "C"
