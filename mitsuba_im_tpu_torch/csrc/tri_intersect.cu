// Brute-force ray/triangle intersection for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _closest_kernel and _anyhit_kernel of
// mitsuba_im_tpu/accel/pallas_intersect.py (:79, :130).  Python binding and
// plain PyTorch versions: mitsuba_im_tpu_torch/accel/cuda_intersect.py.
//
// What bounds them: each ray reads its origin and direction (24 B) and, on
// the main path, writes a 24 B hit record (closest) or reads a 4 B tmax and
// writes 1 B (any hit): ~15 us / ~9 us per 2^20 rays at 3.35 TB/s.  The
// arithmetic is the reference's Moeller-Trumbore, unfused (-fmad=false)
// and with an IEEE reciprocal: the closest-hit loop issues 82.5 SASS
// instructions for a pair that passes every test, 29 for one that det
// rejects, 52 after u, 71.5 after v (the loop is unrolled by two).  A warp
// issues, per triangle, the furthest stage one of its lanes reaches, so at
// 12 triangles the card's issue rate, not its memory, sets the floor
// (~21 us on the Cornell camera rays), and at 512 triangles it rules
// (chip_smoke.issue_floor_ms).
//
// Design: one thread per ray, BLOCK threads per block, grid ceil(n/BLOCK),
// the ragged edge masked by n.  Each block stages the soup (T <= MAX_TRIS)
// in shared memory as three float4 per triangle, in the order the test
// reads them, so a pair costs three broadcast loads instead of nine.  The
// test takes each of the reference's rejections as soon as the rounded
// value it needs exists: |det| <= 1e-12 (before the division), then u,
// then v, then t.  Every test is written in the negated form of the
// reference's conjunction (cuda_intersect.py's _moeller_trumbore), so a
// NaN rejects wherever the reference's would.
// Signs are not tested before the division: u = a * inv_det may round to
// -0.0, which passes u >= 0.  The closest-hit kernel updates only on a
// strictly smaller t, which reproduces the argmin tie rule (lowest index
// wins) of the plain version; the any-hit kernel stops at the first
// blocking triangle.
//
// tmin and tmax are each a plane with a stride (0: one value for every
// ray, a 0-dim or expanded tensor) or, with a null pointer, one float
// argument: no per-call fill.  With tri_shape set, the closest-hit kernel
// writes the hit record of a scene of triangles only (t, kind, prim,
// shape, u, v; accel/intersect.py's merge when no sphere or disk can be
// hit) in place of (t, u, v, prim, found).
//
// Arithmetic is the reference's op for op and in its order; built with
// -fmad=false and without fast math, every operation rounds as the plain
// PyTorch version's.  KIND_NONE, KIND_TRI and INVALID_ID come from the
// build flags (cuda_intersect.BUILD_FLAGS, scene/geometry.py).

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(KIND_NONE) || !defined(KIND_TRI) || !defined(INVALID_ID)
#error "build with cuda_intersect.BUILD_FLAGS (-DKIND_NONE, -DKIND_TRI, -DINVALID_ID)"
#endif

#define TRI_INTERFACE 2
#define MAX_TRIS 512
#define BLOCK 256
#define BIG 3.0e37f

// tmin or tmax: a plane read at i * stride, or `value` when p is null
struct Bound {
  const float* p;
  long long stride;
  float value;
};

struct Args {
  const float* o[3];
  const float* d[3];
  Bound tmin, tmax;
  const float* p0;  // (T, 3) each
  const float* e1;
  const float* e2;
  int T, n;
  const int* tri_shape;  // closest hit: the hit record when set
  float* t;
  float* u;
  float* v;
  int* prim;
  uint8_t* found;  // (t, u, v, prim, found); any hit: blocked
  int* kind;       // hit record: (t, kind, prim, shape, u, v)
  int* shape;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
};

__device__ __forceinline__ float bound_at(const Bound& b, int i) {
  return b.p ? b.p[(long long)i * b.stride] : b.value;
}

__device__ __forceinline__ Ray load_ray(const Args& a, int i) {
  Ray r;
  r.ox = a.o[0][i];
  r.oy = a.o[1][i];
  r.oz = a.o[2][i];
  r.dx = a.d[0][i];
  r.dy = a.d[1][i];
  r.dz = a.d[2][i];
  r.tmin = bound_at(a.tmin, i);
  return r;
}

// Triangle k as s[3k..3k+2] = (e2x, e2y, e2z, e1x), (e1y, e1z, p0x, p0y),
// (p0z, 0, 0, 0): 24 KB for MAX_TRIS.
__device__ __forceinline__ void stage_tris(float4* s, const Args& a) {
  for (int k = threadIdx.x; k < a.T; k += blockDim.x) {
    const float* p0 = a.p0 + 3 * k;
    const float* e1 = a.e1 + 3 * k;
    const float* e2 = a.e2 + 3 * k;
    s[3 * k + 0] = make_float4(e2[0], e2[1], e2[2], e1[0]);
    s[3 * k + 1] = make_float4(e1[1], e1[2], p0[0], p0[1]);
    s[3 * k + 2] = make_float4(p0[2], 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
}

// The reference's Moeller-Trumbore against staged triangle k: true on
// tmin < t < tlim inside, with t, u, v set.
__device__ __forceinline__ bool hit_test(const Ray& r, const float4* s,
                                         int k, float tlim, float& t_out,
                                         float& u_out, float& v_out) {
  const float4 a = s[3 * k], b = s[3 * k + 1];
  const float e2x = a.x, e2y = a.y, e2z = a.z, e1x = a.w;
  const float e1y = b.x, e1z = b.y, p0x = b.z, p0y = b.w;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (!(fabsf(det) > 1e-12f)) return false;
  // det != 0 here, so the reference's det == 0 guard does not change it
  const float inv_det = 1.0f / det;
  const float tx = r.ox - p0x;
  const float ty = r.oy - p0y;
  const float tz = r.oz - s[3 * k + 2].x;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  // u > 1 is rejected too: with v >= 0, u + v rounds to >= u > 1
  // (rounding is monotone), so the reference's u + v <= 1 fails
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  if (!(v >= 0.0f && u + v <= 1.0f)) return false;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  if (!(t > r.tmin && t < tlim)) return false;
  t_out = t;
  u_out = u;
  v_out = v;
  return true;
}

template <bool RECORD>
__global__ void __launch_bounds__(BLOCK) closest_kernel(const Args a) {
  __shared__ float4 s[3 * MAX_TRIS];
  stage_tris(s, a);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a, i);
  // NaN tmax stays NaN (as torch.clamp does) and then admits no hit
  const float tm = bound_at(a.tmax, i);
  float t_best = tm > BIG ? BIG : tm;
  float u_best = 0.0f, v_best = 0.0f;
  int idx = -1;
  for (int k = 0; k < a.T; ++k) {
    float t, u, v;
    if (hit_test(r, s, k, t_best, t, u, v)) {
      t_best = t;
      u_best = u;
      v_best = v;
      idx = k;
    }
  }
  const bool found = idx >= 0;
  a.t[i] = found ? t_best : BIG;
  a.u[i] = u_best;
  a.v[i] = v_best;
  a.prim[i] = found ? idx : 0;
  if (RECORD) {
    a.kind[i] = found ? KIND_TRI : KIND_NONE;
    a.shape[i] = found ? a.tri_shape[idx] : INVALID_ID;
  } else {
    a.found[i] = found ? 1 : 0;
  }
}

__global__ void __launch_bounds__(BLOCK) anyhit_kernel(const Args a) {
  __shared__ float4 s[3 * MAX_TRIS];
  stage_tris(s, a);
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a, i);
  const float tm = bound_at(a.tmax, i);
  bool blocked = false;
  for (int k = 0; k < a.T && !blocked; ++k) {
    float t, u, v;
    blocked = hit_test(r, s, k, tm, t, u, v);
  }
  a.found[i] = blocked ? 1 : 0;
}

static Args make_args(const float* ox, const float* oy, const float* oz,
                      const float* dx, const float* dy, const float* dz,
                      const float* tmin, long long tmin_stride,
                      float tmin_value, const float* tmax,
                      long long tmax_stride, float tmax_value,
                      const float* p0, const float* e1, const float* e2,
                      int T, int n) {
  Args a = {};
  a.o[0] = ox;
  a.o[1] = oy;
  a.o[2] = oz;
  a.d[0] = dx;
  a.d[1] = dy;
  a.d[2] = dz;
  a.tmin = {tmin, tmin_stride, tmin_value};
  a.tmax = {tmax, tmax_stride, tmax_value};
  a.p0 = p0;
  a.e1 = e1;
  a.e2 = e2;
  a.T = T;
  a.n = n;
  return a;
}

static inline bool bad_args(int n, int T) {
  return n < 0 || T < 1 || T > MAX_TRIS;
}

// The version of the entry points below (1: before this query existed).
extern "C" int tri_interface() { return TRI_INTERFACE; }

// Closest hit: (t, u, v, prim, found) when tri_shape is null, else the
// hit record (t, kind, prim, shape, u, v) and `found` is not written.
extern "C" int tri_closest(const float* ox, const float* oy, const float* oz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tmin, long long tmin_stride,
                           float tmin_value, const float* tmax,
                           long long tmax_stride, float tmax_value,
                           const float* p0, const float* e1, const float* e2,
                           int T, int n, const int* tri_shape, float* t,
                           float* u, float* v, int* prim, uint8_t* found,
                           int* kind, int* shape, void* stream) {
  if (bad_args(n, T)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Args a = make_args(ox, oy, oz, dx, dy, dz, tmin, tmin_stride, tmin_value,
                     tmax, tmax_stride, tmax_value, p0, e1, e2, T, n);
  a.tri_shape = tri_shape;
  a.t = t;
  a.u = u;
  a.v = v;
  a.prim = prim;
  a.found = found;
  a.kind = kind;
  a.shape = shape;
  const int grid = (n + BLOCK - 1) / BLOCK;
  if (tri_shape)
    closest_kernel<true><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(a);
  else
    closest_kernel<false><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int tri_anyhit(const float* ox, const float* oy, const float* oz,
                          const float* dx, const float* dy, const float* dz,
                          const float* tmin, long long tmin_stride,
                          float tmin_value, const float* tmax,
                          long long tmax_stride, float tmax_value,
                          const float* p0, const float* e1, const float* e2,
                          int T, int n, uint8_t* blocked, void* stream) {
  if (bad_args(n, T)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Args a = make_args(ox, oy, oz, dx, dy, dz, tmin, tmin_stride, tmin_value,
                     tmax, tmax_stride, tmax_value, p0, e1, e2, T, n);
  a.found = blocked;
  const int grid = (n + BLOCK - 1) / BLOCK;
  anyhit_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
