// K2: 3x3x3 DoG extremum test, packed into int32 words.
//
// Replaces the TPU kernel sift_features_tpu/ops/pallas/extrema_kernel.py:
// extrema_words_batched (_kernel). Same test (lib.rs:437-506 with the JAX
// package's quirk): v > 0 && v >= max of the 27-cube, or v < 0 && v <= min,
// inside the padded-coordinate bounds [y0, y1) x [x0, x1); zero outside.
// Word (f, s, y, w) holds columns 32w..32w+31 of row y, bit j = column
// 32w + j (bit 31 is the int32 sign bit).
//
// Bound on the H100: memory. It must read the 5 DoG planes of each frame
// once (5 x 37.7 MB per frame at octave 0 of a 1080p batch) and write 3/32
// of a plane; the compare work is small. One thread per pixel and scale;
// the 27 reads of neighbouring threads overlap in L1, and a warp ballot
// over 32 consecutive columns forms each word with no shared memory.
// Out-of-plane neighbours are never read: the bounds lie >= 1 pixel
// (in fact >= pad + border) inside the plane.
#include "common.cuh"

__global__ void extrema_words_kernel(const float* __restrict__ dog,
                                     int* __restrict__ words, int n_s, int Hp,
                                     int Wp, int y0, int y1, int x0, int x1) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int fs = blockIdx.z;            // frame * n_s + (s - 1)
  int f = fs / n_s;
  int s = fs % n_s + 1;
  long long plane = (long long)Hp * Wp;
  bool m = false;
  if (y >= y0 && y < y1 && x >= x0 && x < x1) {
    const float* c = dog + ((long long)f * (n_s + 2) + s) * plane + (long long)y * Wp + x;
    float v = c[0];
    float mx = v, mn = v;
    for (int ds = -1; ds <= 1; ++ds)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          float q = c[ds * plane + dy * Wp + dx];
          mx = fmaxf(mx, q);
          mn = fminf(mn, q);
        }
    m = (v > 0.0f && v >= mx) || (v < 0.0f && v <= mn);
  }
  unsigned bits = __ballot_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0)
    words[((long long)fs * Hp + y) * (Wp / 32) + x / 32] = (int)bits;
}

// dog (B, n_s + 2, Hp, Wp) f32 -> words (B, n_s, Hp, Wp / 32) int32.
// Wp must be a multiple of 128 (every block covers whole words).
SIFT_EXPORT int sift_extrema_words(const float* dog, int* words, int B, int n_s,
                                   int Hp, int Wp, int y0, int y1, int x0, int x1,
                                   cudaStream_t stream) {
  if (Wp % 128 != 0) return (int)cudaErrorInvalidValue;
  dim3 block(128);
  dim3 grid(Wp / 128, Hp, B * n_s);
  extrema_words_kernel<<<grid, block, 0, stream>>>(dog, words, n_s, Hp, Wp, y0,
                                                   y1, x0, x1);
  return (int)cudaGetLastError();
}
