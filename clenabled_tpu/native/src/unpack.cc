// High-rate host-side unpack & marshalling.
//
// The reference unpacks packed-4-bit / signed-byte I/Q on the GPU
// (CharToComplex, /root/reference/lib/clXEngine_impl.cc:831-858) and
// marshals antenna streams into [time][station][chan][pol] on the host in
// C++ (:982-1061).  Here the unpack targets PLANAR float pairs
// (the device-side format — see clenabled_tpu/dsp/planar.py) and runs on
// the host ingest path where the bytes arrive.  Plain loops; g++ -O3
// autovectorizes them.

#include <cstddef>
#include <cstdint>

namespace {

// Two's-complement 4-bit LUT, scale 1/7 (clXEngine_impl.cc:835-837).
const float kLut4[16] = {0.f,          1.f / 7.f,  2.f / 7.f,  3.f / 7.f,
                         4.f / 7.f,    5.f / 7.f,  6.f / 7.f,  7.f / 7.f,
                         0.f,          -7.f / 7.f, -6.f / 7.f, -5.f / 7.f,
                         -4.f / 7.f,   -3.f / 7.f, -2.f / 7.f, -1.f / 7.f};

constexpr float kInvSchar = 1.0f / 127.0f;

}  // namespace

extern "C" {

// n bytes in → n planar complex samples (high nibble = I, low = Q).
void unpack_4bit_planar(const uint8_t* in, float* re, float* im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint8_t b = in[i];
    re[i] = kLut4[b >> 4];
    im[i] = kLut4[b & 0x0F];
  }
}

// 2n interleaved signed bytes (I,Q) → n planar complex samples, scale 1/127.
void unpack_i8_planar(const int8_t* in, float* re, float* im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = (float)in[2 * i] * kInvSchar;
    im[i] = (float)in[2 * i + 1] * kInvSchar;
  }
}

// Interleaved complex64 (r,i pairs) → planar floats.
void deinterleave_c64(const float* in, float* re, float* im, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    re[i] = in[2 * i];
    im[i] = in[2 * i + 1];
  }
}

// Planar floats → interleaved complex64.
void interleave_c64(const float* re, const float* im, float* out, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    out[2 * i] = re[i];
    out[2 * i + 1] = im[i];
  }
}

// X-Engine input marshal: per-station contiguous planar blocks
// [station][time*chan*pol] → [time][station][chan][pol]
// (clXEngine_impl.cc:982-1061's layout, planar).
void marshal_xengine_planar(const float* const* station_data, float* out,
                            size_t n_stations, size_t n_time,
                            size_t chan_pol) {
  for (size_t t = 0; t < n_time; ++t) {
    for (size_t s = 0; s < n_stations; ++s) {
      const float* src = station_data[s] + t * chan_pol;
      float* dst = out + (t * n_stations + s) * chan_pol;
      for (size_t k = 0; k < chan_pol; ++k) dst[k] = src[k];
    }
  }
}

}  // extern "C"
