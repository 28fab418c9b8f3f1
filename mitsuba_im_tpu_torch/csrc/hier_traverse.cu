// Two-level cluster-hierarchy traversal for Hopper (sm_90a): closest hit
// (hier_closest) and any hit (hier_anyhit) of each ray over the tables of
// mitsuba_im_tpu_torch/accel/hierarchy.py.
//
// Replaces the three Pallas TPU kernels of mitsuba_im_tpu/accel/
// hier_kernel.py: _step_kernel (:81, one traversal round per lane of an
// (M, 35) state matrix, instanced tables), _step_kernel2 (:285, the same
// round with the child table resident) and _advance_kernel (:439, the
// full-width sweep-and-first-child prologue).  Those kernels cut the
// traversal into rounds because a TPU core runs a grid in order over dense
// tiles, with a host-side driver compacting lanes between rounds.  On the
// card each thread owns one ray and runs the whole traversal in a loop, so
// the state matrix, the one-hot matmuls and the driver all disappear: this
// computes what intersect_hierarchy computes, not the Pallas tiles.
//
// Per thread, as the reference's _make_state / _one_step, one step per
// loop iteration:
//   1. root-box prepass over the n_supers real supers (and `active`);
//   2. lex-gated nearest-super sweep: the smallest (entry t, id) strictly
//      after the last super entered, with tn <= tf, tn < FAR and the exit
//      clipped by the current best t; none left -> done;
//   3. entering a super: an instanced table moves the ray into the
//      instance's space through inst_inv[sup_inst[s]] (direction not
//      renormalised, so t stays world t); an indirect table reads its
//      rows at base sup_blas[s];
//   4. lex-gated nearest child among the super's 64 (entry <= best t);
//      none left -> the next step sweeps (2).  The exit of each child slab is clipped by
//      the current best t at every pick, where the reference caches the
//      entries when it enters the super and gates them by the current best
//      t afterwards: a child passes there iff ctn <= min(far, t_enter),
//      ctn < FAR and ctn <= t_now, and since t_now <= t_enter that is
//      ctn <= min(far, t_now) and ctn < FAR, the test here;
//   5. Moeller-Trumbore against the cluster's 64 triangles, replacing the
//      best hit only on a strictly smaller t, so on exact-t ties in a row
//      the lowest slot wins (the reference's masked-min pick); any-hit
//      returns at the first hit.
// Padded triangle slots are all zero (det == 0 never hits); padded child
// boxes sit at FAR and never pass; direction components below 1e-20 are
// clamped to +-1e-20 before the reciprocal (hierarchy.py:441, :537).
//
// Layout: one thread per ray, BLOCK threads per block, the ragged edge
// masked by n.  The (6, n_supers) super boxes go to shared memory when
// n_supers <= SMEM_SUPERS (48 KB); the 1.12M-triangle scene has a few
// hundred supers (~10 KB).  Child rows (384 f32) and cluster rows
// (640 f32, 2.5 KB) are read from global memory through the read-only
// cache (__ldg).  The sweep and child loops are unrolled by 4; nothing is
// unrolled by hand.
//
// What bounds it on the H100: per ray, the ray I/O (~58 B) and, once for
// all rays, the tables (~2.6 KB per cluster); the arithmetic is ~12 flops
// per box test (every super at each sweep, 64 children at each pick) and
// ~40 per triangle test (64 per cluster).  At the large scene's camera
// rays the operation count dominates (chip_smoke.py computes both bounds
// from the plain version's counters).  The simple design does nothing
// against divergence (rays visit 0 to many clusters) or the scattered
// 2.5 KB row reads; ray reordering and warp-cooperative cluster tests are
// later work.  Predicted before its first timed run: ~0.5-2 ms per call at
// the 768^2 camera rays of the 1.12M-triangle scene (~560 supers swept
// twice per ray at ~25 instructions each, warps diverging), against an
// operations bound of ~0.15 ms.  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at 700 W: 563 supers, 1.77 sweeps per camera ray, bound
// 0.135 ms; 12.8 ms with nested loops (each ray of a warp sweeping at its
// own time), 5.7 ms with one reference step per iteration, 3.7-3.8 ms
// (closest) and 5.4-5.6 ms (any hit) with the loops unrolled by 4.  The
// sweep over every super is ~78% of the flops.
//
// Built with -fmad=false and without fast math, so every operation rounds
// as in the plain PyTorch version (hierarchy.py::intersect_hierarchy_plain)
// and the two agree bit for bit on found, prim, inst, t, u and v.

#include <cuda_runtime.h>
#include <stdint.h>

#define LEAF 64
#define SUP 64
#define ROW (LEAF * 9 + LEAF)
#define CROW (SUP * 6)
#define BLOCK 128
#define SMEM_SUPERS 2048
#define BIG 3.0e37f
#define FAR 1.0e30f

struct Tables {
  const float* swp_lo;  // (3, s_pad)
  const float* swp_hi;
  int s_pad, n_supers;
  const float* childs;  // (S, CROW)
  const float* blocks;  // (C, ROW)
  const int* sup_inst;  // (s_pad,)
  const float* inst_inv;  // (I, 3, 4)
  const int* sup_blas;  // (s_pad,) when indirect
  const float* root;  // (6,) lo xyz, hi xyz
  int instanced, indirect;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax;
  const uint8_t* active;  // may be null
  int n;
};

struct Hits {
  float *t, *u, *v;
  int *prim, *inst;
  uint8_t* found;  // any-hit: the blocked flags
};

__device__ __forceinline__ float safe_inv(float d) {
  const float ds = fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d;
  return 1.0f / ds;
}

// Slab test of one box: entry (max of the per-axis near planes and tmin)
// and exit (min of the far planes and tlim), in the plain version's order.
__device__ __forceinline__ void slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     float ox, float oy, float oz, float ix,
                                     float iy, float iz, float tmin,
                                     float tlim, float* tn, float* tf) {
  const float ax0 = (lox - ox) * ix, ax1 = (hix - ox) * ix;
  const float ay0 = (loy - oy) * iy, ay1 = (hiy - oy) * iy;
  const float az0 = (loz - oz) * iz, az1 = (hiz - oz) * iz;
  *tn = fmaxf(fmaxf(fminf(ax0, ax1), fminf(ay0, ay1)),
              fmaxf(fminf(az0, az1), tmin));
  *tf = fminf(fminf(fmaxf(ax0, ax1), fmaxf(ay0, ay1)),
              fminf(fmaxf(az0, az1), tlim));
}

// The smallest (entry t, id) strictly after (sg_t, sg_c) among the n boxes
// of the planes lo[k * stride + s], hi[k * stride + s] that the ray enters
// before min(exit, tb) and before FAR; se = BIG when none.
__device__ __forceinline__ void nearest_super(
    const float* lo, const float* hi, int stride, int n, float ox, float oy,
    float oz, float ix, float iy, float iz, float tmin, float tb, float sg_t,
    int sg_c, float* se_out, int* sid_out) {
  float se = BIG;
  int sid = 0;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    float tn, tf;
    slab(lo[s], lo[stride + s], lo[2 * stride + s], hi[s], hi[stride + s],
         hi[2 * stride + s], ox, oy, oz, ix, iy, iz, tmin, tb, &tn, &tf);
    const bool ok =
        tn <= tf && tn < FAR && (tn > sg_t || (tn == sg_t && s > sg_c));
    if (ok && tn < se) {
      se = tn;
      sid = s;
    }
  }
  *se_out = se;
  *sid_out = sid;
}

template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
hier_kernel(Tables h, Rays r, Hits out) {
  extern __shared__ float s_swp[];  // (6, n_supers) when it fits
  const int ns = h.n_supers;
  const bool in_smem = ns <= SMEM_SUPERS;
  if (in_smem) {
    for (int s = threadIdx.x; s < ns; s += blockDim.x) {
      for (int k = 0; k < 3; ++k) {
        s_swp[k * ns + s] = h.swp_lo[k * h.s_pad + s];
        s_swp[(3 + k) * ns + s] = h.swp_hi[k * h.s_pad + s];
      }
    }
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.n) return;

  const float ox = r.ox[i], oy = r.oy[i], oz = r.oz[i];
  const float dx = r.dx[i], dy = r.dy[i], dz = r.dz[i];
  const float tmin = r.tmin[i], tmax = r.tmax[i];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  float tb = fminf(BIG, tmax), ub = 0.0f, vb = 0.0f;
  int pb = 0, ib = 0;
  bool found = false;

  float tn, tf;
  slab(h.root[0], h.root[1], h.root[2], h.root[3], h.root[4], h.root[5], ox,
       oy, oz, ix, iy, iz, tmin, tmax, &tn, &tf);
  bool live = tn <= tf && (r.active == nullptr || r.active[i] != 0);

  // Traversal state between steps (the reference's lane state).
  float sg_t = -BIG, ig_t = -BIG;  // super / child lex gates
  int sg_c = -1, ig_c = -1;
  bool has_super = false;
  int inst = 0, base = 0;
  float olx = ox, oly = oy, olz = oz, dlx = dx, dly = dy, dlz = dz;
  float ilx = ix, ily = iy, ilz = iz;
  // One iteration is one step of the reference's _one_step: a sweep if
  // the ray has no super, one child pick, one cluster test.  Keeping the
  // step shape lets the rays of a warp that need a sweep run it together
  // instead of one after another.
  while (live) {
    if (!has_super) {
      // --- 2. lex-gated nearest super ------------------------------------
      float se;
      int sid;
      if (in_smem)
        nearest_super(s_swp, s_swp + 3 * ns, ns, ns, ox, oy, oz, ix, iy, iz,
                      tmin, tb, sg_t, sg_c, &se, &sid);
      else
        nearest_super(h.swp_lo, h.swp_hi, h.s_pad, ns, ox, oy, oz, ix, iy, iz,
                      tmin, tb, sg_t, sg_c, &se, &sid);
      if (!(se < BIG)) break;
      sg_t = se;
      sg_c = sid;

      // --- 3. enter the super --------------------------------------------
      inst = h.instanced ? __ldg(h.sup_inst + sid) : 0;
      if (h.instanced) {
        const float* m = h.inst_inv + 12 * inst;
        float ol[3], dl[3];
        for (int k = 0; k < 3; ++k) {
          const float m0 = __ldg(m + 4 * k), m1 = __ldg(m + 4 * k + 1);
          const float m2 = __ldg(m + 4 * k + 2), m3 = __ldg(m + 4 * k + 3);
          ol[k] = ((m0 * ox + m1 * oy) + m2 * oz) + m3;
          dl[k] = (m0 * dx + m1 * dy) + m2 * dz;
        }
        olx = ol[0], oly = ol[1], olz = ol[2];
        dlx = dl[0], dly = dl[1], dlz = dl[2];
        ilx = safe_inv(dlx), ily = safe_inv(dly), ilz = safe_inv(dlz);
      }
      base = h.indirect ? __ldg(h.sup_blas + sid) : sid;
      ig_t = -BIG;
      ig_c = -1;
      has_super = true;
    }

    // --- 4. lex-gated nearest child --------------------------------------
    const float* crow = h.childs + (size_t)base * CROW;
    float emin = BIG;
    int kk = 0;
#pragma unroll 4
    for (int k = 0; k < SUP; ++k) {
      float ctn, ctf;
      slab(__ldg(crow + k), __ldg(crow + SUP + k), __ldg(crow + 2 * SUP + k),
           __ldg(crow + 3 * SUP + k), __ldg(crow + 4 * SUP + k),
           __ldg(crow + 5 * SUP + k), olx, oly, olz, ilx, ily, ilz, tmin, tb,
           &ctn, &ctf);
      const bool ok = ctn <= ctf && ctn < FAR && ctn <= tb &&
                      (ctn > ig_t || (ctn == ig_t && k > ig_c));
      if (ok && ctn < emin) {
        emin = ctn;
        kk = k;
      }
    }
    if (!(emin < BIG)) {
      has_super = false;
      continue;
    }
    ig_t = emin;
    ig_c = kk;

    // --- 5. Moeller-Trumbore on the cluster row ----------------------------
    const float* row = h.blocks + ((size_t)base * SUP + kk) * ROW;
    for (int j = 0; j < LEAF; ++j) {
      const float e1x = __ldg(row + 3 * LEAF + j);
      const float e1y = __ldg(row + 4 * LEAF + j);
      const float e1z = __ldg(row + 5 * LEAF + j);
      const float e2x = __ldg(row + 6 * LEAF + j);
      const float e2y = __ldg(row + 7 * LEAF + j);
      const float e2z = __ldg(row + 8 * LEAF + j);
      const float px = dly * e2z - dlz * e2y;
      const float py = dlz * e2x - dlx * e2z;
      const float pz = dlx * e2y - dly * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool ok = fabsf(det) > 1e-12f;
      const float inv_det = ok ? 1.0f / det : 0.0f;
      const float tx = olx - __ldg(row + j);
      const float ty = oly - __ldg(row + LEAF + j);
      const float tz = olz - __ldg(row + 2 * LEAF + j);
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (dlx * qx + dly * qy + dlz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
          t < tb) {
        found = true;
        if (ANY) {
          out.found[i] = 1;
          return;
        }
        tb = t;
        ub = u;
        vb = v;
        pb = __float_as_int(__ldg(row + 9 * LEAF + j));
        ib = inst;
      }
    }
  }
  if (ANY) {
    out.found[i] = 0;
    return;
  }
  out.t[i] = tb;
  out.u[i] = ub;
  out.v[i] = vb;
  out.prim[i] = pb;
  out.inst[i] = ib;
  out.found[i] = found ? 1 : 0;
}

template <bool ANY>
static int launch(const Tables& h, const Rays& r, const Hits& out,
                  void* stream) {
  if (r.n < 0 || h.n_supers < 1 || h.n_supers > h.s_pad)
    return (int)cudaErrorInvalidValue;
  if (r.n == 0) return 0;
  const size_t smem =
      h.n_supers <= SMEM_SUPERS ? 6 * (size_t)h.n_supers * sizeof(float) : 0;
  const int grid = (r.n + BLOCK - 1) / BLOCK;
  hier_kernel<ANY><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(h, r, out);
  return (int)cudaGetLastError();
}

#define HIER_ARGS                                                             \
  const float *ox, const float *oy, const float *oz, const float *dx,         \
      const float *dy, const float *dz, const float *tmin, const float *tmax, \
      const uint8_t *active, int n, const float *swp_lo,                      \
      const float *swp_hi, int s_pad, int n_supers, const float *childs,      \
      const float *blocks, const int *sup_inst, const float *inst_inv,        \
      const int *sup_blas, const float *root, int instanced, int indirect

#define HIER_STRUCTS                                                       \
  const Tables h = {swp_lo, swp_hi,   s_pad, n_supers, childs,   blocks,   \
                    sup_inst, inst_inv, sup_blas, root, instanced, indirect}; \
  const Rays r = {ox, oy, oz, dx, dy, dz, tmin, tmax, active, n}

extern "C" int hier_closest(HIER_ARGS, float* t, float* u, float* v,
                            int* prim, int* inst, uint8_t* found,
                            void* stream) {
  HIER_STRUCTS;
  const Hits out = {t, u, v, prim, inst, found};
  return launch<false>(h, r, out, stream);
}

extern "C" int hier_anyhit(HIER_ARGS, uint8_t* blocked, void* stream) {
  HIER_STRUCTS;
  const Hits out = {nullptr, nullptr, nullptr, nullptr, nullptr, blocked};
  return launch<true>(h, r, out, stream);
}
