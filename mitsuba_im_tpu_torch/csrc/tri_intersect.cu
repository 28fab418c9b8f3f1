// Brute-force ray/triangle intersection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _closest_kernel and _anyhit_kernel of
// mitsuba_im_tpu/accel/pallas_intersect.py (:79, :130).  Python binding and
// plain PyTorch reference: mitsuba_im_tpu_torch/accel/cuda_intersect.py.
//
// Design: one thread per ray, BLOCK threads per block, grid ceil(n/BLOCK),
// the ragged edge masked by n.  Each block first stages the whole triangle
// soup (T <= MAX_TRIS, p0/e1/e2 as nine SoA component rows, at most
// 512 x 9 x 4 B = 18 KB of static shared memory) and then every thread
// walks it in ascending triangle index; all threads of a warp read the same
// triangle, so the shared loads are broadcasts.  The closest-hit kernel
// updates only on a strictly smaller t, which reproduces the argmin tie rule
// (lowest index wins) of the CPU reference; the any-hit kernel exits on the
// first blocking triangle.
//
// Arithmetic is the reference's Moeller-Trumbore op for op (inv_det
// multiply, det == 0 guard, |det| > 1e-12); built with -fmad=false and
// without fast math so every operation rounds as the plain PyTorch version's.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_TRIS 512
#define BLOCK 256
#define BIG 3.0e37f

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
};

__device__ __forceinline__ void stage_tris(float (*s)[MAX_TRIS],
                                           const float* __restrict__ p0,
                                           const float* __restrict__ e1,
                                           const float* __restrict__ e2,
                                           int T) {
  for (int k = threadIdx.x; k < T; k += blockDim.x) {
    s[0][k] = p0[3 * k + 0];
    s[1][k] = p0[3 * k + 1];
    s[2][k] = p0[3 * k + 2];
    s[3][k] = e1[3 * k + 0];
    s[4][k] = e1[3 * k + 1];
    s[5][k] = e1[3 * k + 2];
    s[6][k] = e2[3 * k + 0];
    s[7][k] = e2[3 * k + 1];
    s[8][k] = e2[3 * k + 2];
  }
  __syncthreads();
}

// Moeller-Trumbore against triangle k; true on tmin < t < tlim inside.
__device__ __forceinline__ bool moeller_trumbore(const float (*s)[MAX_TRIS],
                                                 int k, const Ray& r,
                                                 float tlim, float* t_out,
                                                 float* u_out, float* v_out) {
  const float e1x = s[3][k], e1y = s[4][k], e1z = s[5][k];
  const float e2x = s[6][k], e2y = s[7][k], e2z = s[8][k];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
  const float tx = r.ox - s[0][k];
  const float ty = r.oy - s[1][k];
  const float tz = r.oz - s[2][k];
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmin &&
         t < tlim;
}

__device__ __forceinline__ Ray load_ray(int i, const float* __restrict__ ox,
                                        const float* __restrict__ oy,
                                        const float* __restrict__ oz,
                                        const float* __restrict__ dx,
                                        const float* __restrict__ dy,
                                        const float* __restrict__ dz,
                                        const float* __restrict__ tmin) {
  Ray r;
  r.ox = ox[i];
  r.oy = oy[i];
  r.oz = oz[i];
  r.dx = dx[i];
  r.dy = dy[i];
  r.dz = dz[i];
  r.tmin = tmin[i];
  return r;
}

__global__ void __launch_bounds__(BLOCK) closest_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ p0, const float* __restrict__ e1,
    const float* __restrict__ e2, int n, int T, float* __restrict__ t_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ prim_out, uint8_t* __restrict__ found_out) {
  __shared__ float s[9][MAX_TRIS];
  stage_tris(s, p0, e1, e2, T);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, ox, oy, oz, dx, dy, dz, tmin);
  // NaN tmax stays NaN (as torch.clamp does) and then admits no hit
  const float tm = tmax[i];
  float t_best = tm > BIG ? BIG : tm;
  float u_best = 0.0f, v_best = 0.0f;
  int idx = -1;
  for (int k = 0; k < T; ++k) {
    float t, u, v;
    if (moeller_trumbore(s, k, r, t_best, &t, &u, &v)) {
      t_best = t;
      u_best = u;
      v_best = v;
      idx = k;
    }
  }
  const bool found = idx >= 0;
  t_out[i] = found ? t_best : BIG;
  u_out[i] = u_best;
  v_out[i] = v_best;
  prim_out[i] = found ? idx : 0;
  found_out[i] = found ? 1 : 0;
}

__global__ void __launch_bounds__(BLOCK) anyhit_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const float* __restrict__ p0, const float* __restrict__ e1,
    const float* __restrict__ e2, int n, int T,
    uint8_t* __restrict__ blocked_out) {
  __shared__ float s[9][MAX_TRIS];
  stage_tris(s, p0, e1, e2, T);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(i, ox, oy, oz, dx, dy, dz, tmin);
  const float tm = tmax[i];
  uint8_t blocked = 0;
  for (int k = 0; k < T; ++k) {
    float t, u, v;
    if (moeller_trumbore(s, k, r, tm, &t, &u, &v)) {
      blocked = 1;
      break;
    }
  }
  blocked_out[i] = blocked;
}

static inline int check_args(int n, int T) {
  if (n < 0 || T < 1 || T > MAX_TRIS) return (int)cudaErrorInvalidValue;
  return 0;
}

extern "C" int tri_closest(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmin, const float* tmax,
                           const float* p0, const float* e1, const float* e2,
                           int n, int T, float* t, float* u, float* v,
                           int* prim, uint8_t* found, void* stream) {
  const int bad = check_args(n, T);
  if (bad) return bad;
  if (n == 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  closest_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tmin, tmax, p0, e1, e2, n, T, t, u, v, prim,
      found);
  return (int)cudaGetLastError();
}

extern "C" int tri_anyhit(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* tmin, const float* tmax,
                          const float* p0, const float* e1, const float* e2,
                          int n, int T, uint8_t* blocked, void* stream) {
  const int bad = check_args(n, T);
  if (bad) return bad;
  if (n == 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  anyhit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      ox, oy, oz, dx, dy, dz, tmin, tmax, p0, e1, e2, n, T, blocked);
  return (int)cudaGetLastError();
}
