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
// tiles, with a host-side driver compacting lanes between rounds.  Here one
// warp runs the whole traversal of one ray, so the state matrix, the
// one-hot matmuls and the driver all disappear: this computes what
// intersect_hierarchy computes, not the Pallas tiles.
//
// Per ray, as the reference's _make_state / _one_step, one step per loop
// iteration:
//   1. root-box prepass (and `active`);
//   2. lex-gated nearest-super sweep: the smallest (entry t, id) strictly
//      after the last super entered, with tn <= tf, tn < FAR and the exit
//      clipped by the current best t; none left -> done;
//   3. entering a super: an instanced table moves the ray into the
//      instance's space through inst_inv[sup_inst[s]] (direction not
//      renormalised, so t stays world t); an indirect table reads its
//      rows at base sup_blas[s]; the entries of the 64 children are
//      computed once, clipped by the best t of that moment.  That is exact:
//      a child's entry does not depend on the best t and its exit only
//      falls with it, so "entry <= min(exit, t_now)" is "entry <=
//      min(exit, t_entered)" and "entry <= t_now";
//   4. lex-gated nearest child among them with entry <= the current best
//      t; none left -> the next step sweeps (2);
//   5. Moeller-Trumbore against the cluster's 64 triangles: the hit of
//      smallest (t, slot) with t < best t replaces the best hit, so on
//      exact-t ties in a row the lowest slot wins (the reference's
//      masked-min pick); any hit ends an any-hit traversal.
// Padded triangle slots are all zero (det == 0 never hits); padded child
// boxes sit at FAR and never pass; direction components below 1e-20 are
// clamped to +-1e-20 before the reciprocal (hierarchy.py:441, :537).
//
// Two reformulations of the sweep (2) keep every result bit for bit:
// - The super list.  The first sweep writes each super the ray enters,
//   (tn, id) with tn <= tf and tn < FAR, into a list of at most KLIST
//   entries in shared memory; every later sweep is the lex-gated minimum
//   over the list alone, among the entries with tn <= the current best t.
//   A super's entry tn = max(near planes, tmin) does not depend on the best
//   t, and its exit tf = min(far planes, best t) only falls as the best t
//   falls.  So a super passes a later sweep iff tn <= min(far planes,
//   t_now), tn < FAR and it is lex after the last super entered; since
//   t_now <= t_first it passed tn <= min(far planes, t_first) at the first
//   sweep and is in the list, and a list entry passes iff tn <= t_now and
//   the lex gate.  A ray whose first sweep enters more than KLIST supers
//   keeps full sweeps (exact as well; not a fallback to another device).
// - Culling the first sweep.  It tests the box of each run of 32
//   consecutive supers (Hierarchy.sweep_groups, lo = min and hi = max over
//   the run of each super's planes taken in order) and the supers of the
//   runs the ray enters only.  Subtraction and multiplication by the same
//   reciprocal round monotonically, so a box holding a super's box gives a
//   near plane no later and a far plane no earlier on every axis, hence
//   tn_run <= tn and tf_run >= tf: a super the ray enters is never culled.
// The supers are read from global memory through L1, 32 consecutive ones
// per warp load (coalesced), so any number of supers takes the same path.
//
// Layout: one ray per warp.  A child row (384 f32) and a cluster row (640
// f32, 2.5 KB) are read as planes of 64 values, lane l holding slots 2l and
// 2l + 1 as one float2, so each row read is coalesced and each byte is read
// once.  Minima are taken over the warp with __reduce_min_sync on an
// unsigned key in float order, then on the slot among the lanes holding
// the minimum: lexicographic on (t, slot), which is what the reference's
// in-order strict-less pick gives.  The list slots come from
// __ballot_sync / __popc.  All lanes hold the ray's state.  Warps are
// persistent: each pulls CHUNK = 4 consecutive rays at a time from 16 ray
// counters interleaved by chunk (one counter would serialise the pulls),
// one load per lane fetching the chunk's 8 x 4 inputs a chunk ahead.  The
// last block to finish sets the counters back to zero, so the caller
// zeroes them once and keeps them for every later launch on its stream.
// KLIST, SWEEP_GROUP and COUNTER_WORDS come from the build flags of
// accel/cuda_hierarchy.py, which owns them; the checks below hold them to
// this kernel's layout.
//
// What bounds it (bench_hier_kernels.py on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit, see PERF.md): ~0.83 ms per call for the large scene's
// 768^2 camera rays, of which ~0.09 ms is the host queueing the call
// (~0.70 ms when the call is queued before the card reaches it), ~5-6x the
// 0.135 ms operations bound of chip_smoke.py (which counts a full sweep per
// sweep step, ~1000 supers per camera ray; this kernel tests ~120).  A
// build that only reads the inputs, takes the
// reciprocals, tests the root box and writes the outputs takes ~0.1 ms, one
// that stops after the first sweep ~0.3 ms; the rest is the children and
// clusters, bound by the latency of each step's dependent row read and
// warp reductions, not by bytes: more registers per thread with fewer
// warps per SM (2 blocks of 256 instead of 3) is slower.  A half-warp per
// ray (G = 16) and blocks with one ray per warp and no counters were
// slower; staging the cluster row with cp.async gained nothing.  Tensor
// cores do not apply: the slab and Moeller-Trumbore tests share no
// reduction dimension, and bit-exactness needs unfused float32.
//
// The motion mode (MOTION, the entry points hier_closest_motion and
// hier_anyhit_motion) traverses a deformable mesh's hierarchy: one SAH
// build over the union of its two keyframes' triangle boxes, both frames'
// cluster rows in one order (blocks, blocks1).  Each cluster test reads
// the frame-1 row's nine geometric planes beside frame 0's and lerps them
// at the pass's shutter time as (1 - time) * a + time * b, the products
// and the sum rounded one by one (the reference's XLA driver,
// hierarchy.py:573-579, and intersect_hierarchy_plain's _rows_at_time);
// the primitive ids come from frame 0.  The static mode compiles as
// before (MOTION false removes the branch: the same registers and spills,
// ptxas -v as chip_smoke.py's build phase prints it).  The motion mode
// holds the second row's planes while it lerps, at the same 80-register
// cap (ptxas: the closest-hit instantiation spills 240 bytes of stores,
// its static twin 104, the any-hit ones none).  On the 1.12M-triangle
// sphere moved a fifth of its radius (chip_smoke.py, NVIDIA H100 80GB
// HBM3, 700 W) a 768^2 camera call takes 2.39-2.46 ms of device time
// against 2.02-2.09 for the static mode on the same tables, the union
// boxes making ~5.5 cluster tests a ray against the static scene's ~0.8.
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
#define G 32  // lanes per ray: one warp
#define FULL 0xffffffffu
#define CHUNK 4  // consecutive rays per counter pull: 8 inputs x 4 = 32
#define BLOCK 256
#define MIN_BLOCKS 3  // per SM: at most 80 registers a thread
#define COUNTERS 16  // ray counters, interleaved by chunk
#define COUNTER_STRIDE 32  // unsigned: one counter per 128 bytes
#define GROUPS (BLOCK / G)
#define INTERFACE 3  // the C entry points' version (hier_interface)
#if !defined(KLIST) || !defined(SWEEP_GROUP) || !defined(COUNTER_WORDS)
#error "build with -DKLIST, -DSWEEP_GROUP and -DCOUNTER_WORDS"
#endif
// KLIST: supers a ray's list holds; SWEEP_GROUP: supers per culling box,
// one warp's load; COUNTER_WORDS: the ray counters and the count of the
// blocks done, one per COUNTER_STRIDE words.
static_assert(SWEEP_GROUP == G, "a culling box covers one warp's supers");
static_assert(COUNTER_WORDS == (COUNTERS + 1) * COUNTER_STRIDE,
              "the counter buffer's layout");
static_assert(KLIST > 0, "the list holds at least one super");
#define BIG 3.0e37f
#define FAR 1.0e30f
#define NONE 0x7fffffff

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
  const float* groups;  // (6, ceil(n_supers / 32)) boxes of runs of 32
  int instanced, indirect;
  const float* blocks1;  // (C, ROW) frame-1 cluster rows (motion mode)
  float time;  // the pass's shutter time (motion mode)
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

// A ray in world space (origin, clamped reciprocal direction, tmin) and
// what the traversal starts from.
struct Ray {
  float ox, oy, oz, ix, iy, iz, tmin;
};

struct RayIn {
  Ray w;
  float dx, dy, dz, tmax;
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

// (t, k) after (gt, gk) in the lex order: the reference's gate.
__device__ __forceinline__ bool lex_after(float t, int k, float gt, int gk) {
  return t > gt || (t == gt && k > gk);
}

// An unsigned key in the order of the floats (not NaN), -0 and +0 alike.
__device__ __forceinline__ unsigned order_key(float t) {
  unsigned u = __float_as_uint(t);
  u = u == 0x80000000u ? 0u : u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The warp's smallest (t, k) in the lex order, in every lane: the smallest
// t, then the smallest k among the lanes holding it.  *t comes back with
// the sign of a zero lost (it only gates comparisons after).
__device__ __forceinline__ void warp_min(float* t, int* k) {
  const unsigned key = order_key(*t);
  const unsigned kmin = __reduce_min_sync(FULL, key);
  *k = (int)__reduce_min_sync(FULL,
                              key == kmin ? (unsigned)*k : (unsigned)NONE);
  *t = key_value(kmin);
}

// Two consecutive floats at p (8-byte aligned), and one of them.
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

__device__ __forceinline__ float slot(float2 v, int q) {
  return q ? v.y : v.x;
}

// One step of a ray's first sweep: lane `lane` tests super s0 + lane (if
// below n) and the supers the ray enters are appended to its list.
__device__ __forceinline__ void list_step(int lane, const float* lo,
                                          const float* hi, int stride, int n,
                                          int s0, const Ray& r, float tb,
                                          float* lt, int* lid, int* cnt) {
  const int s = s0 + lane;
  bool in = false;
  float tn = BIG, tf;
  if (s < n) {
    slab(__ldg(lo + s), __ldg(lo + stride + s), __ldg(lo + 2 * stride + s),
         __ldg(hi + s), __ldg(hi + stride + s), __ldg(hi + 2 * stride + s),
         r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, r.tmin, tb, &tn, &tf);
    in = tn <= tf && tn < FAR;
  }
  if (__any_sync(FULL, in)) {  // most steps enter nothing
    const unsigned m = __ballot_sync(FULL, in);
    const int pos = *cnt + __popc(m & ((1u << lane) - 1u));
    if (in && pos < KLIST) {
      lt[pos] = tn;
      lid[pos] = s;
    }
    *cnt += __popc(m);
  }
}

// A ray's first sweep: every super of the n boxes (planes
// lo[k * stride + s], hi[k * stride + s]) it enters, tn <= min(exit, tb)
// and tn < FAR, in id order; the first KLIST go to lt/lid.  Returns how
// many it entered.  The supers are tested 32 at a time, and only the runs
// of 32 whose bounding box (gb: planes of ng) the ray enters.
__device__ __forceinline__ int list_supers(int lane, const float* lo,
                                           const float* hi, int stride,
                                           int n, const float* gb,
                                           const Ray& r, float tb, float* lt,
                                           int* lid) {
  const int ng = (n + G - 1) / G;
  int cnt = 0;
  __syncwarp();  // the previous ray's list reads are done
  for (int g0 = 0; g0 < ng; g0 += G) {
    const int gi = g0 + lane;
    bool gin = false;
    if (gi < ng) {
      float tn, tf;
      slab(__ldg(gb + gi), __ldg(gb + ng + gi), __ldg(gb + 2 * ng + gi),
           __ldg(gb + 3 * ng + gi), __ldg(gb + 4 * ng + gi),
           __ldg(gb + 5 * ng + gi), r.ox, r.oy, r.oz, r.ix, r.iy, r.iz,
           r.tmin, tb, &tn, &tf);
      gin = tn <= tf && tn < FAR;
    }
    for (unsigned m = __ballot_sync(FULL, gin); m; m &= m - 1)
      list_step(lane, lo, hi, stride, n, (g0 + __ffs(m) - 1) * G, r, tb, lt,
                lid, &cnt);
  }
  __syncwarp();  // the list is visible to the whole warp
  return cnt;
}

// The lex-gated nearest super after (sg_t, sg_c) among the list's cnt
// entries with tn <= tb: (se, sid), se = BIG when none.
__device__ __forceinline__ void list_sweep(int lane, const float* lt,
                                           const int* lid, int cnt, float tb,
                                           float sg_t, int sg_c, float* se,
                                           int* sid) {
  float bt = BIG;
  int bs = NONE;
  for (int j = lane; j < cnt; j += G) {
    const float tn = lt[j];
    const int s = lid[j];
    if (tn <= tb && lex_after(tn, s, sg_t, sg_c) &&
        (tn < bt || (tn == bt && s < bs))) {
      bt = tn;
      bs = s;
    }
  }
  warp_min(&bt, &bs);
  *se = bt;
  *sid = bs;
}

// The same over all n supers, for a ray whose list overflowed.
__device__ __forceinline__ void full_sweep(int lane, const float* lo,
                                           const float* hi, int stride,
                                           int n, const Ray& r, float tb,
                                           float sg_t, int sg_c, float* se,
                                           int* sid) {
  float bt = BIG;
  int bs = NONE;
  for (int s = lane; s < n; s += G) {
    float tn, tf;
    slab(__ldg(lo + s), __ldg(lo + stride + s), __ldg(lo + 2 * stride + s),
         __ldg(hi + s), __ldg(hi + stride + s), __ldg(hi + 2 * stride + s),
         r.ox, r.oy, r.oz, r.ix, r.iy, r.iz, r.tmin, tb, &tn, &tf);
    if (tn <= tf && tn < FAR && lex_after(tn, s, sg_t, sg_c) && tn < bt) {
      bt = tn;
      bs = s;
    }
  }
  warp_min(&bt, &bs);
  *se = bt;
  *sid = bs;
}

// The lex-gated nearest child after (gt, gk) among this lane's children
// 2l, 2l + 1 (entries ce, FAR when missed) with entry <= tb, over the
// warp: (e, k), e = BIG when none.
__device__ __forceinline__ void pick_child(int lane, const float* ce,
                                           float tb, float gt, int gk,
                                           float* e, int* k) {
  *e = BIG;
  *k = NONE;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int kq = 2 * lane + q;
    if (ce[q] < FAR && ce[q] <= tb && lex_after(ce[q], kq, gt, gk) &&
        ce[q] < *e) {
      *e = ce[q];
      *k = kq;
    }
  }
  warp_min(e, k);
}

// The traversal of one live ray after its first sweep listed n_list
// supers in lt/lid (steps 2-5 of the note).  MOTION lerps the nine
// geometric planes of each cluster row between the two keyframes' tables
// at the pass's shutter time, (1 - time) * frame0 + time * frame1 (the
// reference's XLA driver, hierarchy.py:573-579), and reads the primitive
// ids from frame 0.
template <bool ANY, bool MOTION>
__device__ __forceinline__ void traverse(int lane, const Tables& h,
                                         const RayIn& r, const float* lt,
                                         const int* lid, int n_list,
                                         float* t_out, float* u_out,
                                         float* v_out, int* p_out,
                                         int* i_out, bool* f_out) {
  const Ray& wr = r.w;
  const float tmin = wr.tmin;
  float tb = fminf(BIG, r.tmax), ub = 0.0f, vb = 0.0f;
  int pb = 0, ib = 0;
  bool found = false;

  // Traversal state between steps (the reference's lane state).
  float sg_t = -BIG;  // super lex gate
  int sg_c = -1;
  float emin = BIG;  // the child to test next, (entry, slot)
  int kk = NONE;
  int inst = 0, base = 0;
  float ce[2] = {FAR, FAR};  // entries of this lane's two children
  Ray lr = wr;  // the ray in the current super's space
  float dlx = r.dx, dly = r.dy, dlz = r.dz;
  for (;;) {
    if (kk == NONE) {
      // --- 2. lex-gated nearest super ------------------------------------
      float se;
      int sid;
      if (n_list <= KLIST)
        list_sweep(lane, lt, lid, n_list, tb, sg_t, sg_c, &se, &sid);
      else
        full_sweep(lane, h.swp_lo, h.swp_hi, h.s_pad, h.n_supers, wr, tb,
                   sg_t, sg_c, &se, &sid);
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
          ol[k] = ((m0 * wr.ox + m1 * wr.oy) + m2 * wr.oz) + m3;
          dl[k] = (m0 * r.dx + m1 * r.dy) + m2 * r.dz;
        }
        dlx = dl[0], dly = dl[1], dlz = dl[2];
        lr = Ray{ol[0], ol[1], ol[2], safe_inv(dlx), safe_inv(dly),
                 safe_inv(dlz), tmin};
      }
      base = h.indirect ? __ldg(h.sup_blas + sid) : sid;

      // the entries of the super's 64 children (lane: 2l, 2l + 1), FAR
      // for a child the ray misses before min(exit, best t)
      const float* crow = h.childs + (size_t)base * CROW + 2 * lane;
      float2 c[6];
#pragma unroll
      for (int p = 0; p < 6; ++p) c[p] = load2(crow + p * SUP);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float ctn, ctf;
        slab(slot(c[0], q), slot(c[1], q), slot(c[2], q), slot(c[3], q),
             slot(c[4], q), slot(c[5], q), lr.ox, lr.oy, lr.oz, lr.ix, lr.iy,
             lr.iz, tmin, tb, &ctn, &ctf);
        ce[q] = ctn <= ctf && ctn < FAR ? ctn : FAR;
      }
      // --- 4. lex-gated nearest child --------------------------------------
      pick_child(lane, ce, tb, -BIG, -1, &emin, &kk);
      if (kk == NONE) continue;  // the next step sweeps
    }

    // --- 5. Moeller-Trumbore on the cluster row (triangles 2l, 2l + 1) -----
    const float* row = h.blocks + ((size_t)base * SUP + kk) * ROW;
    float2 tr[9];
#pragma unroll
    for (int p = 0; p < 9; ++p) tr[p] = load2(row + p * LEAF + 2 * lane);
    if (MOTION) {
      const float* row1 = h.blocks1 + ((size_t)base * SUP + kk) * ROW;
      const float w0 = 1.0f - h.time, w1 = h.time;
#pragma unroll
      for (int p = 0; p < 9; ++p) {
        const float2 b = load2(row1 + p * LEAF + 2 * lane);
        tr[p].x = w0 * tr[p].x + w1 * b.x;
        tr[p].y = w0 * tr[p].y + w1 * b.y;
      }
    }
    float lt_best = BIG, lu = 0.0f, lv = 0.0f;
    int lj = NONE;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float e1x = slot(tr[3], q), e1y = slot(tr[4], q);
      const float e1z = slot(tr[5], q), e2x = slot(tr[6], q);
      const float e2y = slot(tr[7], q), e2z = slot(tr[8], q);
      const float px = dly * e2z - dlz * e2y;
      const float py = dlz * e2x - dlx * e2z;
      const float pz = dlx * e2y - dly * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool ok = fabsf(det) > 1e-12f;
      const float inv_det = ok ? 1.0f / det : 0.0f;
      const float tx = lr.ox - slot(tr[0], q);
      const float ty = lr.oy - slot(tr[1], q);
      const float tz = lr.oz - slot(tr[2], q);
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (dlx * qx + dly * qy + dlz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      if (ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
          t < tb && t < lt_best) {
        lt_best = t;
        lu = u;
        lv = v;
        lj = 2 * lane + q;
      }
    }
    if (ANY) {
      if (__any_sync(FULL, lj != NONE)) {
        found = true;
        break;
      }
    } else {
      float tw = lt_best;
      int jw = lj;
      warp_min(&tw, &jw);
      if (jw != NONE) {  // the exact t, u, v from the lane that found it
        const int owner = jw >> 1;
        found = true;
        tb = __shfl_sync(FULL, lt_best, owner);
        ub = __shfl_sync(FULL, lu, owner);
        vb = __shfl_sync(FULL, lv, owner);
        pb = __float_as_int(__ldg(row + 9 * LEAF + jw));
        ib = inst;
      }
    }
    // --- 4. the next child of this super, after the one just tested -------
    pick_child(lane, ce, tb, emin, kk, &emin, &kk);
  }
  *t_out = tb;
  *u_out = ub;
  *v_out = vb;
  *p_out = pb;
  *i_out = ib;
  *f_out = found;
}

// The rays' eight inputs: lane l of a warp loads input l / CHUNK of ray
// l % CHUNK of a chunk, so one load per lane fetches a whole chunk.
__device__ __forceinline__ const float* lane_input(const Rays& rays,
                                                   int lane) {
  const float* in[8] = {rays.ox, rays.oy, rays.oz, rays.dx,
                        rays.dy, rays.dz, rays.tmin, rays.tmax};
  const int k = lane / CHUNK;
  const float* p = in[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) p = k == j ? in[j] : p;
  return p;
}

// This lane's input of the chunk at i0 and, in lanes below CHUNK, the
// active flag of ray i0 + lane (1 when there is no mask).
__device__ __forceinline__ void fetch_chunk(const Rays& rays,
                                            const float* input, int lane,
                                            unsigned i0, float* v,
                                            uint8_t* act) {
  const unsigned i = i0 + lane % CHUNK;
  *v = i < (unsigned)rays.n ? __ldg(input + i) : 0.0f;
  *act = 1;
  if (rays.active != nullptr && lane < CHUNK && i < (unsigned)rays.n)
    *act = __ldg(rays.active + i);
}

// The first ray of the next chunk for this warp, or n when none is left.
// Chunk c + COUNTERS * k is the k-th chunk of counter c; a warp starts at
// its own counter and moves on to the next when that one runs dry.
__device__ __forceinline__ unsigned pull(unsigned* next, int lane, int n,
                                         int* c, int* tried) {
  while (*tried < COUNTERS) {
    unsigned k = 0;
    if (lane == 0) k = atomicAdd(next + *c * COUNTER_STRIDE, 1u);
    k = __shfl_sync(FULL, k, 0);
    const unsigned i0 = (*c + COUNTERS * k) * CHUNK;
    if (i0 < (unsigned)n) return i0;
    *c = (*c + 1) % COUNTERS;
    ++*tried;
  }
  return (unsigned)n;
}

// Persistent warps: each pulls CHUNK consecutive rays from the counters,
// fetching the next chunk's inputs while it traces the current one.  The
// current chunk's inputs wait in shared memory (cin), not in registers.
template <bool ANY, bool MOTION>
__device__ __forceinline__ void run(const Tables& h, const Rays& rays,
                                    const Hits& out, unsigned* next,
                                    float* lt, int* lid, float* cin,
                                    uint8_t* cact) {
  const int lane = threadIdx.x % G;
  const float* input = lane_input(rays, lane);
  int c = (blockIdx.x * GROUPS + threadIdx.x / G) % COUNTERS, tried = 0;
  unsigned i0 = pull(next, lane, rays.n, &c, &tried);
  float v_next;
  uint8_t a_next;
  fetch_chunk(rays, input, lane, i0, &v_next, &a_next);
  while (i0 < (unsigned)rays.n) {
    const unsigned cur = i0;
    __syncwarp();  // the previous chunk's inputs are read
    cin[lane] = v_next;
    // lanes 3 * CHUNK .. 6 * CHUNK - 1 hold the direction: its reciprocal
    cin[G + lane] = safe_inv(v_next);
    if (lane < CHUNK) cact[lane] = a_next;
    __syncwarp();
    i0 = pull(next, lane, rays.n, &c, &tried);
    fetch_chunk(rays, input, lane, i0, &v_next, &a_next);
#pragma unroll 1
    for (int j = 0; j < CHUNK; ++j) {
      const unsigned i = cur + j;
      if (i >= (unsigned)rays.n) break;
      RayIn r;
      r.dx = cin[3 * CHUNK + j];
      r.dy = cin[4 * CHUNK + j];
      r.dz = cin[5 * CHUNK + j];
      r.tmax = cin[7 * CHUNK + j];
      r.w = Ray{cin[j], cin[CHUNK + j], cin[2 * CHUNK + j],
                cin[G + 3 * CHUNK + j], cin[G + 4 * CHUNK + j],
                cin[G + 5 * CHUNK + j], cin[6 * CHUNK + j]};
      float tn, tf;
      slab(__ldg(h.root), __ldg(h.root + 1), __ldg(h.root + 2),
           __ldg(h.root + 3), __ldg(h.root + 4), __ldg(h.root + 5), r.w.ox,
           r.w.oy, r.w.oz, r.w.ix, r.w.iy, r.w.iz, r.w.tmin, r.tmax, &tn,
           &tf);
      const bool live = tn <= tf && cact[j] != 0;
      float t = fminf(BIG, r.tmax), u = 0.0f, vv = 0.0f;
      int p = 0, in = 0;
      bool f = false;
      if (live) {
        const int n_list = list_supers(lane, h.swp_lo, h.swp_hi, h.s_pad,
                                       h.n_supers, h.groups, r.w, t, lt, lid);
        traverse<ANY, MOTION>(lane, h, r, lt, lid, n_list, &t, &u, &vv, &p,
                              &in, &f);
      }
      if (lane != 0) continue;
      out.found[i] = f ? 1 : 0;
      if (!ANY) {
        out.t[i] = t;
        out.u[i] = u;
        out.v[i] = vv;
        out.prim[i] = p;
        out.inst[i] = in;
      }
    }
  }
}

template <bool ANY, bool MOTION>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
hier_kernel(Tables h, Rays r, Hits out, unsigned* next) {
  __shared__ float lt[GROUPS][KLIST];  // each warp's super list
  __shared__ int lid[GROUPS][KLIST];
  __shared__ float cin[GROUPS][2 * G];  // the chunk's inputs, reciprocals
  __shared__ uint8_t cact[GROUPS][CHUNK];
  const int warp = threadIdx.x / G;
  run<ANY, MOTION>(h, r, out, next, lt[warp], lid[warp], cin[warp],
                   cact[warp]);
  // Every pull of this block is done; the last block done has seen every
  // pull of the launch and sets the counters back to zero.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    unsigned* done = next + COUNTERS * COUNTER_STRIDE;
    if (atomicAdd(done, 1u) == gridDim.x - 1) {
      for (int c = 0; c < COUNTERS; ++c) next[c * COUNTER_STRIDE] = 0u;
      *done = 0u;
    }
  }
}

// Blocks of hier_kernel<ANY, MOTION> resident on device dev at once,
// queried at the first launch on that device and kept.
template <bool ANY, bool MOTION>
static cudaError_t resident_blocks(int dev, int* blocks) {
  static int known[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, hier_kernel<ANY, MOTION>, BLOCK, 0);
    if (e != cudaSuccess) return e;
    known[dev] = per_sm * sms;
  }
  *blocks = known[dev];
  return cudaSuccess;
}

template <bool ANY, bool MOTION>
static int launch(const Tables& h, const Rays& r, const Hits& out,
                  unsigned* next, void* stream) {
  if (r.n < 0 || h.n_supers < 1 || h.n_supers > h.s_pad)
    return (int)cudaErrorInvalidValue;
  if (r.n == 0) return 0;
  int dev = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = resident_blocks<ANY, MOTION>(dev, &resident);
  if (e != cudaSuccess) return (int)e;
  const int pulls = (r.n + GROUPS * CHUNK - 1) / (GROUPS * CHUNK);
  int grid = resident < pulls ? resident : pulls;
  if (grid < 1) grid = 1;
  hier_kernel<ANY, MOTION><<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      h, r, out, next);
  return (int)cudaGetLastError();
}

#define HIER_ARGS                                                             \
  const float *ox, const float *oy, const float *oz, const float *dx,         \
      const float *dy, const float *dz, const float *tmin, const float *tmax, \
      const uint8_t *active, int n, const float *swp_lo,                      \
      const float *swp_hi, int s_pad, int n_supers, const float *childs,      \
      const float *blocks, const int *sup_inst, const float *inst_inv,        \
      const int *sup_blas, const float *root, const float *groups,           \
      int instanced, int indirect

#define HIER_STRUCTS(BLOCKS1, TIME)                                        \
  const Tables h = {swp_lo,   swp_hi,   s_pad,     n_supers, childs,        \
                    blocks,   sup_inst, inst_inv,  sup_blas, root,          \
                    groups,   instanced, indirect, BLOCKS1,  TIME};         \
  const Rays r = {ox, oy, oz, dx, dy, dz, tmin, tmax, active, n}

// The version of the entry points below, for a binding to check.
extern "C" int hier_interface(void) { return INTERFACE; }

// `next`: COUNTER_WORDS unsigned, zero before the first launch and left
// zero by each launch; launches sharing them run on one stream.
extern "C" int hier_closest(HIER_ARGS, float* t, float* u, float* v,
                            int* prim, int* inst, uint8_t* found,
                            unsigned* next, void* stream) {
  HIER_STRUCTS(nullptr, 0.0f);
  const Hits out = {t, u, v, prim, inst, found};
  return launch<false, false>(h, r, out, next, stream);
}

extern "C" int hier_anyhit(HIER_ARGS, uint8_t* blocked, unsigned* next,
                           void* stream) {
  HIER_STRUCTS(nullptr, 0.0f);
  const Hits out = {nullptr, nullptr, nullptr, nullptr, nullptr, blocked};
  return launch<true, false>(h, r, out, next, stream);
}

// The motion mode (interface 3): blocks1, the frame-1 rows (C, ROW) in the
// order of blocks, and time, the pass's shutter time in [0, 1].
extern "C" int hier_closest_motion(HIER_ARGS, const float* blocks1,
                                   float time, float* t, float* u, float* v,
                                   int* prim, int* inst, uint8_t* found,
                                   unsigned* next, void* stream) {
  HIER_STRUCTS(blocks1, time);
  const Hits out = {t, u, v, prim, inst, found};
  return launch<false, true>(h, r, out, next, stream);
}

extern "C" int hier_anyhit_motion(HIER_ARGS, const float* blocks1,
                                  float time, uint8_t* blocked,
                                  unsigned* next, void* stream) {
  HIER_STRUCTS(blocks1, time);
  const Hits out = {nullptr, nullptr, nullptr, nullptr, nullptr, blocked};
  return launch<true, true>(h, r, out, next, stream);
}
