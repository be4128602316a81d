// K2's streaming-read probe: a measurement aid, on no path of the package.
//
// Reads once the DoG values that K2 (csrc/extrema.cu) needs, rows
// [y0 - 1, y1] and columns [x0 - 1, x1] of the S + 2 planes of each frame
// (clipped to the plane; columns widened to whole 4-column groups), 4
// columns a thread with one 16-byte load in f32 or one 8-byte load in
// bf16, and writes the words of those rows (bit j: some plane > 0 at
// column 32w + j), with no stencil. Its time is what K2's reads cost at the
// rate the card gives this access pattern.
#include "common.cuh"

#define PROBE_FULL 0xffffffffu

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
// bf16: its f32 value is its bits shifted up 16
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// thread t of the grid's x range takes columns xw + 4t .. xw + 4t + 3 (xw a
// multiple of 32, so 8 threads make a word); it reads them if they lie in
// [xa, xb)
template <typename T>
__global__ void k2_stream_kernel(const T* __restrict__ dog, int* __restrict__ words, int n_s,
                                 int Hp, int Wp, int ya, int xw, int xa, int xb) {
  int x = xw + (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  int y = ya + blockIdx.y, f = blockIdx.z;
  long long plane = (long long)Hp * Wp;
  unsigned nib = 0;
  if (x >= xa && x < xb) {
    const T* c = dog + (long long)f * (n_s + 2) * plane + (long long)y * Wp + x;
    for (int p = 0; p < n_s + 2; ++p) {
      float v[4];
      load4(c + p * plane, v);
      for (int j = 0; j < 4; ++j) nib |= (v[j] > 0.0f ? 1u : 0u) << j;
    }
  }
  int lane = threadIdx.x & 31;
  unsigned wd = nib << (4 * (lane & 7));
  wd |= __shfl_xor_sync(PROBE_FULL, wd, 1);
  wd |= __shfl_xor_sync(PROBE_FULL, wd, 2);
  wd |= __shfl_xor_sync(PROBE_FULL, wd, 4);
  if ((lane & 7) == 0 && x + 32 > xa && x < xb)
    for (int s = 0; s < n_s; ++s)
      words[((long long)(f * n_s + s) * Hp + y) * (Wp / 32) + x / 32] = (int)wd;
}

// dog (B, n_s + 2, Hp, Wp) of type dog_t (f32 or bf16), the bounds of K2
// -> words (B, n_s, Hp, Wp / 32) int32, written at the rows read. Wp must
// be a multiple of 128, as for K2.
SIFT_EXPORT int sift_k2_stream_probe(const void* dog, int dog_t, int* words, int B, int n_s,
                                     int Hp, int Wp, int y0, int y1, int x0, int x1,
                                     cudaStream_t stream) {
  if (Wp % 128 != 0) return (int)cudaErrorInvalidValue;
  int ya = y0 - 1 < 0 ? 0 : y0 - 1, yb = y1 + 1 > Hp ? Hp : y1 + 1;
  int xa = (x0 - 1 < 0 ? 0 : x0 - 1) & ~3;
  int xb = (x1 + 1 + 3) & ~3;
  xb = xb > Wp ? Wp : xb;
  if (yb <= ya || xb <= xa) return 0;
  int xw = xa & ~31;
  int nx = (xb - xw + 3) / 4;
  dim3 grid((nx + 127) / 128, yb - ya, B);
  if (dog_t == SIFT_BF16)
    k2_stream_kernel<bf16><<<grid, 128, 0, stream>>>((const bf16*)dog, words, n_s, Hp, Wp, ya,
                                                     xw, xa, xb);
  else if (dog_t == SIFT_F32)
    k2_stream_kernel<float><<<grid, 128, 0, stream>>>((const float*)dog, words, n_s, Hp, Wp,
                                                      ya, xw, xa, xb);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
