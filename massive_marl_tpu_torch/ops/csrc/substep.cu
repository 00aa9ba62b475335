// One physics substep for a batch of ant articulations, one articulation
// per thread (CUDA C++ for sm_90a).
//
// Replaces the TPU kernel massive_marl_tpu/ops/fused_substep.py::_substep_kernel
// (a pallas_call whose body is massive_marl_tpu/ops/scalar_phys.py::substep
// with _contact_force).  The plain PyTorch version with the same arithmetic
// is massive_marl_tpu_torch/ops/scalar_phys.py::substep; both read the same
// flat constant table (scalar_phys.bake_consts), whose field order the
// O_* offsets below repeat.
//
// Per thread, in the reference's order:
//   1. forward kinematics over the body tree;
//   2. plane and box contact for every contact point: implicit
//      effective-mass normal force, exact-stiction Coulomb friction;
//   3. joint-limit spring and damping, folded implicitly into diag(M);
//   4. CRBA mass matrix and velocity-product bias forces;
//   5. dense Cholesky solve (structural zeros of the reference's sparse
//      unrolled factorisation stay exactly 0, so the numbers are the same);
//   6. semi-implicit integration with velocity clamps and quaternion
//      renormalisation;
//   7. the articulation's contact wrench on the box about the box origin,
//      and the foot-sensor wrenches in the foot frames.
//
// Layout: struct-of-arrays [field, B], so thread b reads x[f*B + b] and a
// warp's loads are coalesced; the box state is [field, E] and read at
// env = b / num_ants.  A tail mask replaces the TPU version's padding.
//
// What bounds it on this card: per articulation the kernel moves ~100 floats
// of state (about 16 MB at B = 40,960, ~5 us at 3.35 TB/s) but executes tens
// of thousands of FP32 operations, so it is bound by operations, and in
// practice by register pressure: the per-thread working set (9 body poses,
// 14 motion subspaces, 9 composite inertias, a 14x14 factor) exceeds the 255
// registers a thread may hold and spills to local memory, which the L1 cache
// serves.  This first version accepts the spill (see -Xptxas -v in PERF.md);
// model constants are staged once per block in shared memory so the
// spilled state is the only local-memory traffic.
//
// NaN semantics follow jnp.maximum/minimum/clip (NaN propagates), so a
// blown-up articulation stays non-finite and the environment's blow-up
// check resets it exactly as in the reference.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 9;   // bodies
constexpr int NJ = 8;   // hinges
constexpr int NV = 14;  // dofs
constexpr int NQ = 15;  // position coordinates
constexpr int NS = 4;   // foot sensors
constexpr int NL = NV * (NV + 1) / 2;  // packed lower triangle

// ---- constant table offsets (ops/scalar_phys.py::table_layout) ----
constexpr int O_GRAVITY = 0;
constexpr int O_H = O_GRAVITY + 3;
constexpr int O_H2 = O_H + 1;
constexpr int O_HALF_H = O_H2 + 1;
constexpr int O_KN = O_HALF_H + 1;
constexpr int O_KD = O_KN + 1;
constexpr int O_MAX_DEPEN_VEL = O_KD + 1;
constexpr int O_HC_VEL = O_MAX_DEPEN_VEL + 1;
constexpr int O_HC_CAP = O_HC_VEL + 1;
constexpr int O_ACC_UNITS = O_HC_CAP + 1;
constexpr int O_LIMIT_K = O_ACC_UNITS + 1;
constexpr int O_LIMIT_DAMP = O_LIMIT_K + 1;
constexpr int O_MAX_LIN_VEL = O_LIMIT_DAMP + 1;
constexpr int O_MAX_ANG_VEL = O_MAX_LIN_VEL + 1;
constexpr int O_MAX_DOF_VEL = O_MAX_ANG_VEL + 1;
constexpr int O_HAS_BOX = O_MAX_DOF_VEL + 1;
constexpr int O_BOX_HE = O_HAS_BOX + 1;
constexpr int O_BOX_INV_MASS = O_BOX_HE + 3;
constexpr int O_BOX_INV_INERTIA = O_BOX_INV_MASS + 1;
constexpr int O_PARENT = O_BOX_INV_INERTIA + 9;
constexpr int O_BODY_SENSOR = O_PARENT + NB;
constexpr int O_POINT_START = O_BODY_SENSOR + NB;
constexpr int O_CHAIN_MASK = O_POINT_START + NB + 1;
constexpr int O_BODY_POS = O_CHAIN_MASK + NV;
constexpr int O_BODY_QUAT = O_BODY_POS + NB * 3;
constexpr int O_JNT_AXIS = O_BODY_QUAT + NB * 4;
constexpr int O_JNT_POS = O_JNT_AXIS + NJ * 3;
constexpr int O_JNT_LO = O_JNT_POS + NJ * 3;
constexpr int O_JNT_HI = O_JNT_LO + NJ;
constexpr int O_ARMATURE = O_JNT_HI + NJ;
constexpr int O_DAMPING = O_ARMATURE + NJ;
constexpr int O_MASS = O_DAMPING + NJ;
constexpr int O_INV_MASS = O_MASS + NB;
constexpr int O_COMP_MASS = O_INV_MASS + NB;
constexpr int O_COM = O_COMP_MASS + NB;
constexpr int O_INERTIA = O_COM + NB * 3;
constexpr int O_INERTIA_INV_AUG = O_INERTIA + NB * 9;
constexpr int FIXED_LEN = O_INERTIA_INV_AUG + NB * 9;
// then, for P contact points: point_local [P*3], point_radius [P],
// mu_plane [P], mu_box [P]

constexpr int THREADS = 128;

struct V3 { float x, y, z; };
struct Q4 { float x, y, z, w; };
struct M33 { float m[3][3]; };

__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ float jsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

__device__ __forceinline__ V3 v3(float x, float y, float z) { V3 r; r.x = x; r.y = y; r.z = z; return r; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }

__device__ __forceinline__ V3 mv(const M33& a, V3 v) {
  return v3(a.m[0][0] * v.x + a.m[0][1] * v.y + a.m[0][2] * v.z,
            a.m[1][0] * v.x + a.m[1][1] * v.y + a.m[1][2] * v.z,
            a.m[2][0] * v.x + a.m[2][1] * v.y + a.m[2][2] * v.z);
}
__device__ __forceinline__ V3 mtv(const M33& a, V3 v) {
  return v3(a.m[0][0] * v.x + a.m[1][0] * v.y + a.m[2][0] * v.z,
            a.m[0][1] * v.x + a.m[1][1] * v.y + a.m[2][1] * v.z,
            a.m[0][2] * v.x + a.m[1][2] * v.y + a.m[2][2] * v.z);
}
// R * K * R^T with K a row-major 3x3 from the table, in the reference's
// summation order ((R K) then (R K) R^T, each sum over k = 0, 1, 2)
__device__ __forceinline__ M33 rotate_tensor(const M33& R, const float* K) {
  M33 RK, out;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      RK.m[i][j] = R.m[i][0] * K[0 * 3 + j] + R.m[i][1] * K[1 * 3 + j] + R.m[i][2] * K[2 * 3 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.m[i][j] = RK.m[i][0] * R.m[j][0] + RK.m[i][1] * R.m[j][1] + RK.m[i][2] * R.m[j][2];
  return out;
}

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  Q4 r;
  r.x = a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y;
  r.y = a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x;
  r.z = a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w;
  r.w = a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z;
  return r;
}
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 qv = v3(q.x, q.y, q.z);
  V3 t = scale(cross(qv, v), 2.0f);
  return add(add(v, scale(t, q.w)), cross(qv, t));
}
__device__ __forceinline__ M33 qmat(Q4 q) {
  const float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  M33 r;
  r.m[0][0] = 1 - 2 * (yy + zz); r.m[0][1] = 2 * (xy - wz); r.m[0][2] = 2 * (xz + wy);
  r.m[1][0] = 2 * (xy + wz); r.m[1][1] = 1 - 2 * (xx + zz); r.m[1][2] = 2 * (yz - wx);
  r.m[2][0] = 2 * (xz - wy); r.m[2][1] = 2 * (yz + wx); r.m[2][2] = 1 - 2 * (xx + yy);
  return r;
}

// spatial six-vectors [w0, w1, w2, p0, p1, p2]
struct S6 { float a[6]; };
__device__ __forceinline__ float dot6(const S6& x, const S6& y) {
  float s = x.a[0] * y.a[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) s = s + x.a[i] * y.a[i];
  return s;
}
__device__ __forceinline__ S6 make6(V3 w, V3 p) {
  S6 r; r.a[0] = w.x; r.a[1] = w.y; r.a[2] = w.z; r.a[3] = p.x; r.a[4] = p.y; r.a[5] = p.z; return r;
}
__device__ __forceinline__ V3 ang(const S6& s) { return v3(s.a[0], s.a[1], s.a[2]); }
__device__ __forceinline__ V3 lin(const S6& s) { return v3(s.a[3], s.a[4], s.a[5]); }
__device__ __forceinline__ S6 motion_cross(const S6& v, const S6& m) {
  return make6(cross(ang(v), ang(m)), add(cross(ang(v), lin(m)), cross(lin(v), ang(m))));
}
__device__ __forceinline__ S6 force_cross(const S6& v, const S6& f) {
  return make6(add(cross(ang(v), ang(f)), cross(lin(v), lin(f))), cross(ang(v), lin(f)));
}

// spatial inertia about the base point: [[A, B], [-B, m 1]]
struct SpI { M33 A; M33 B; float m; };
__device__ __forceinline__ S6 imv(const SpI& I, const S6& s) {
  V3 w = ang(s), p = lin(s);
  V3 top = add(mv(I.A, w), mv(I.B, p));
  V3 Bw = mv(I.B, w);
  return make6(top, add(v3(-Bw.x, -Bw.y, -Bw.z), scale(p, I.m)));
}

// inverse mass of a contact along a unit direction: the point's own body,
// plus (for an ant-box contact) the box
struct WFn {
  V3 r; M33 I; float im;
  bool two; V3 rb; M33 bI; float bim;
};
__device__ __forceinline__ float w_eval(const WFn& w, V3 d) {
  V3 rxd = cross(w.r, d);
  float out = w.im + dot(rxd, mv(w.I, rxd));
  if (w.two) {
    V3 rb = cross(w.rb, d);
    out = out + w.bim + dot(rb, mv(w.bI, rb));
  }
  return out;
}

struct Contact { float h, kn, kd, mdv, hc_vel, hc_cap; bool acc_units; };

__device__ __forceinline__ V3 contact_force(float depth, V3 n, V3 v_rel, float mu,
                                            const WFn& w, const Contact& c) {
  const float active = depth > 0.f ? 1.f : 0.f;
  const float vn = dot(v_rel, n);
  const V3 vt = sub(v_rel, scale(n, vn));
  const float vt_norm = sqrtf(dot(vt, vt) + 1e-12f);
  const float w_n = w_eval(w, n);
  const float inv_vt = 1.0f / vt_norm;
  const float w_t = w_eval(w, scale(vt, inv_vt));
  float kn = c.kn;
  if (c.hc_vel != 0.f) {
    float fac = jmax(1.0f - vn / jmax(c.hc_vel, 1e-9f), 0.f);
    if (c.hc_cap > 0.f) fac = jmin(fac, c.hc_cap);
    if (c.hc_vel > 0.f) kn = kn * fac;
  }
  const float kh = kn * c.h + c.kd;
  float fn = c.acc_units ? (kn * depth - kh * vn) / (w_n * (1.0f + c.h * kh))
                         : (kn * depth - kh * vn) / (1.0f + w_n * c.h * kh);
  fn = jmax(fn, 0.f) * active;
  fn = jmin(fn, jmax(c.mdv - vn, 0.f) / (w_n * c.h));
  const float ft = jmin(mu * fn, vt_norm / (w_t * c.h));
  return sub(scale(n, fn), scale(vt, ft / vt_norm));
}

__global__ void __launch_bounds__(THREADS)
substep_kernel(const float* __restrict__ table, int table_len, int P, int num_ants, int B, int E,
               const float* __restrict__ qpos_in, const float* __restrict__ qvel_in,
               const float* __restrict__ tau_in, const float* __restrict__ box_qpos_in,
               const float* __restrict__ box_qvel_in, float* __restrict__ qpos_out,
               float* __restrict__ qvel_out, float* __restrict__ wrench_out,
               float* __restrict__ sens_out) {
  extern __shared__ float T[];
  for (int k = threadIdx.x; k < table_len; k += blockDim.x) T[k] = table[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;

  const float* point_local = T + FIXED_LEN;
  const float* point_radius = point_local + 3 * P;
  const float* mu_plane = point_radius + P;
  const float* mu_box = mu_plane + P;
  const bool has_box = T[O_HAS_BOX] != 0.f;
  const float h = T[O_H], h2 = T[O_H2], half_h = T[O_HALF_H];
  Contact cp;
  cp.h = h; cp.kn = T[O_KN]; cp.kd = T[O_KD]; cp.mdv = T[O_MAX_DEPEN_VEL];
  cp.hc_vel = T[O_HC_VEL]; cp.hc_cap = T[O_HC_CAP]; cp.acc_units = T[O_ACC_UNITS] != 0.f;

  float q[NQ], qd[NV], tau[NJ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) q[k] = qpos_in[k * B + i];
#pragma unroll
  for (int k = 0; k < NV; ++k) qd[k] = qvel_in[k * B + i];
#pragma unroll
  for (int k = 0; k < NJ; ++k) tau[k] = tau_in[k * B + i];

  // ---------------- 1. forward kinematics ----------------
  const V3 base = v3(q[0], q[1], q[2]);
  Q4 base_q; base_q.x = q[3]; base_q.y = q[4]; base_q.z = q[5]; base_q.w = q[6];
  V3 pos[NB];
  Q4 quat[NB];
  S6 phi[NV];
  pos[0] = base;
  quat[0] = base_q;
#pragma unroll
  for (int b = 1; b < NB; ++b) {
    const int j = b - 1;
    const int par = (int)T[O_PARENT + b];
    const V3 p_p = pos[par];
    const Q4 q_p = quat[par];
    const V3 p0 = add(p_p, qrot(q_p, load3(T + O_BODY_POS + 3 * b)));
    Q4 bq; bq.x = T[O_BODY_QUAT + 4 * b]; bq.y = T[O_BODY_QUAT + 4 * b + 1];
    bq.z = T[O_BODY_QUAT + 4 * b + 2]; bq.w = T[O_BODY_QUAT + 4 * b + 3];
    const Q4 q0 = qmul(q_p, bq);
    const V3 n_w = qrot(q0, load3(T + O_JNT_AXIS + 3 * j));
    const float half = 0.5f * q[7 + j];
    const float s = sinf(half);
    Q4 q_rot; q_rot.x = n_w.x * s; q_rot.y = n_w.y * s; q_rot.z = n_w.z * s; q_rot.w = cosf(half);
    const Q4 q_c = qmul(q_rot, q0);
    const V3 jp = load3(T + O_JNT_POS + 3 * j);
    const V3 anchor = add(p0, qrot(q0, jp));
    pos[b] = sub(anchor, qrot(q_c, jp));
    quat[b] = q_c;
    phi[6 + j] = make6(n_w, cross(sub(anchor, base), n_w));
  }
  M33 R[NB];
  V3 com_w[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    R[b] = qmat(quat[b]);
    com_w[b] = add(pos[b], mv(R[b], load3(T + O_COM + 3 * b)));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    V3 e = v3(k == 0 ? 1.f : 0.f, k == 1 ? 1.f : 0.f, k == 2 ? 1.f : 0.f);
    phi[k] = make6(v3(0.f, 0.f, 0.f), e);
    phi[3 + k] = make6(e, v3(0.f, 0.f, 0.f));
  }
  S6 v[NB];
  v[0] = make6(v3(qd[3], qd[4], qd[5]), v3(qd[0], qd[1], qd[2]));
#pragma unroll
  for (int b = 1; b < NB; ++b) {
    const int par = (int)T[O_PARENT + b];
    const int j = 6 + b - 1;
#pragma unroll
    for (int k = 0; k < 6; ++k) v[b].a[k] = v[par].a[k] + phi[j].a[k] * qd[j];
  }

  // ---------------- 2. contacts ----------------
  S6 f_body[NB];
  float box_wrench[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  V3 bp = v3(0.f, 0.f, 0.f), bv = v3(0.f, 0.f, 0.f), bw = v3(0.f, 0.f, 0.f), he = v3(0.f, 0.f, 0.f);
  M33 bR, bIw;
  float bim = 0.f;
  if (has_box) {
    const int env = i / num_ants;
    Q4 bq;
    bq.x = box_qpos_in[3 * E + env]; bq.y = box_qpos_in[4 * E + env];
    bq.z = box_qpos_in[5 * E + env]; bq.w = box_qpos_in[6 * E + env];
    bR = qmat(bq);
    bp = v3(box_qpos_in[env], box_qpos_in[E + env], box_qpos_in[2 * E + env]);
    bv = v3(box_qvel_in[env], box_qvel_in[E + env], box_qvel_in[2 * E + env]);
    bw = v3(box_qvel_in[3 * E + env], box_qvel_in[4 * E + env], box_qvel_in[5 * E + env]);
    he = load3(T + O_BOX_HE);
    bim = T[O_BOX_INV_MASS];
    bIw = rotate_tensor(bR, T + O_BOX_INV_INERTIA);
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    WFn w;
    w.I = rotate_tensor(R[b], T + O_INERTIA_INV_AUG + 9 * b);
    w.im = T[O_INV_MASS + b];
    w.two = false;
    V3 f_sum = v3(0.f, 0.f, 0.f), t_sum = v3(0.f, 0.f, 0.f);
    V3 fb_t = v3(0.f, 0.f, 0.f), fb_f = v3(0.f, 0.f, 0.f);
    const int p_end = (int)T[O_POINT_START + b + 1];
    for (int p = (int)T[O_POINT_START + b]; p < p_end; ++p) {
      const float radius = point_radius[p];
      const V3 p_w = add(pos[b], mv(R[b], load3(point_local + 3 * p)));
      const V3 v_w = add(lin(v[b]), cross(ang(v[b]), sub(p_w, base)));
      w.r = sub(p_w, com_w[b]);
      w.two = false;
      V3 f_pt = contact_force(radius - p_w.z, v3(0.f, 0.f, 1.f), v_w, mu_plane[p], w, cp);
      if (has_box) {
        const V3 local = mtv(bR, sub(p_w, bp));
        const V3 cl = v3(jclip(local.x, -he.x, he.x), jclip(local.y, -he.y, he.y),
                         jclip(local.z, -he.z, he.z));
        const V3 delta = sub(local, cl);
        const float dist_out = sqrtf(dot(delta, delta) + 1e-12f);
        const bool inside = fabsf(local.x) < he.x && fabsf(local.y) < he.y && fabsf(local.z) < he.z;
        const float fp0 = he.x - fabsf(local.x), fp1 = he.y - fabsf(local.y), fp2 = he.z - fabsf(local.z);
        const float min_pen = jmin(jmin(fp0, fp1), fp2);
        const bool m0 = fp0 <= min_pen + 1e-12f;
        const bool m1 = (fp1 <= min_pen + 1e-12f) && !m0;
        const bool m2 = !m0 && !m1;
        const V3 n_in = v3(jsign(local.x) * (m0 ? 1.f : 0.f), jsign(local.y) * (m1 ? 1.f : 0.f),
                           jsign(local.z) * (m2 ? 1.f : 0.f));
        const V3 n_out = scale(delta, 1.0f / dist_out);
        const float insf = inside ? 1.f : 0.f;
        const V3 n_loc = v3(insf * n_in.x + (1 - insf) * n_out.x, insf * n_in.y + (1 - insf) * n_out.y,
                            insf * n_in.z + (1 - insf) * n_out.z);
        const float depth_b = insf * (radius + min_pen) + (1 - insf) * (radius - dist_out);
        const V3 n_w = mv(bR, n_loc);
        const V3 surf = v3(insf * local.x + (1 - insf) * cl.x, insf * local.y + (1 - insf) * cl.y,
                           insf * local.z + (1 - insf) * cl.z);
        const V3 cpnt = add(bp, mv(bR, surf));
        const V3 r_box = sub(cpnt, bp);
        const V3 v_rel = sub(v_w, add(bv, cross(bw, r_box)));
        w.two = true; w.rb = r_box; w.bI = bIw; w.bim = bim;
        const V3 f_bx = contact_force(depth_b, n_w, v_rel, mu_box[p], w, cp);
        f_pt = add(f_pt, f_bx);
        const V3 tq = cross(r_box, f_bx);
        box_wrench[0] = box_wrench[0] + -tq.x; box_wrench[1] = box_wrench[1] + -tq.y;
        box_wrench[2] = box_wrench[2] + -tq.z; box_wrench[3] = box_wrench[3] + -f_bx.x;
        box_wrench[4] = box_wrench[4] + -f_bx.y; box_wrench[5] = box_wrench[5] + -f_bx.z;
      }
      fb_t = add(fb_t, cross(sub(p_w, base), f_pt));
      fb_f = add(fb_f, f_pt);
      f_sum = add(f_sum, f_pt);
      t_sum = add(t_sum, cross(sub(p_w, pos[b]), f_pt));
    }
    f_body[b] = make6(fb_t, fb_f);
    const int s = (int)T[O_BODY_SENSOR + b];
    if (s >= 0) {
      const V3 fl = mtv(R[b], f_sum), tl = mtv(R[b], t_sum);
      float* o = sens_out + (6 * s) * B + i;
      o[0] = fl.x; o[B] = fl.y; o[2 * B] = fl.z; o[3 * B] = tl.x; o[4 * B] = tl.y; o[5 * B] = tl.z;
    }
  }

  // ---------------- 4. bias forces, then CRBA composite inertias ----------------
  S6 avp[NB];
  avp[0] = make6(v3(0.f, 0.f, 0.f), cross(v3(qd[0], qd[1], qd[2]), v3(qd[3], qd[4], qd[5])));
#pragma unroll
  for (int b = 1; b < NB; ++b) {
    const int par = (int)T[O_PARENT + b];
    const int j = 6 + b - 1;
    S6 vJ;
#pragma unroll
    for (int k = 0; k < 6; ++k) vJ.a[k] = phi[j].a[k] * qd[j];
    const S6 mc = motion_cross(v[par], vJ);
#pragma unroll
    for (int k = 0; k < 6; ++k) avp[b].a[k] = avp[par].a[k] + mc.a[k];
  }
  const V3 grav = load3(T + O_GRAVITY);
  SpI Ic[NB];
  S6 fs[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const M33 Iw = rotate_tensor(R[b], T + O_INERTIA + 9 * b);
    const V3 cr = sub(com_w[b], base);
    const float m = T[O_MASS + b];
    M33 cx;
    cx.m[0][0] = 0.f; cx.m[0][1] = -cr.z; cx.m[0][2] = cr.y;
    cx.m[1][0] = cr.z; cx.m[1][1] = 0.f; cx.m[1][2] = -cr.x;
    cx.m[2][0] = -cr.y; cx.m[2][1] = cr.x; cx.m[2][2] = 0.f;
    SpI I;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float cxcx = cx.m[r][0] * cx.m[0][c] + cx.m[r][1] * cx.m[1][c] + cx.m[r][2] * cx.m[2][c];
        I.A.m[r][c] = Iw.m[r][c] - m * cxcx;
        I.B.m[r][c] = m * cx.m[r][c];
      }
    I.m = m;
    const V3 fg = scale(grav, m);
    const S6 f_grav = make6(cross(cr, fg), fg);
    const S6 t1 = imv(I, avp[b]);
    const S6 t2 = force_cross(v[b], imv(I, v[b]));
#pragma unroll
    for (int k = 0; k < 6; ++k) fs[b].a[k] = (t1.a[k] + t2.a[k]) - f_grav.a[k] - f_body[b].a[k];
    Ic[b] = I;
  }
#pragma unroll
  for (int b = NB - 1; b > 0; --b) {
    const int par = (int)T[O_PARENT + b];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Ic[par].A.m[r][c] = Ic[par].A.m[r][c] + Ic[b].A.m[r][c];
        Ic[par].B.m[r][c] = Ic[par].B.m[r][c] + Ic[b].B.m[r][c];
      }
#pragma unroll
    for (int k = 0; k < 6; ++k) fs[par].a[k] = fs[par].a[k] + fs[b].a[k];
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) Ic[b].m = T[O_COMP_MASS + b];

  // mass matrix, packed lower triangle L[j*(j+1)/2 + i] for i <= j
  float L[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) L[k] = 0.f;
  float C[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int body = j < 6 ? 0 : j - 5;
    const S6 fI = imv(Ic[body], phi[j]);
    const int mask = (int)T[O_CHAIN_MASK + j];
#pragma unroll
    for (int i2 = 0; i2 <= j; ++i2)
      if (mask & (1 << i2)) L[j * (j + 1) / 2 + i2] = dot6(phi[i2], fI);
    C[j] = dot6(phi[j], fs[body]);
  }

  // ---------------- 3. joint limits (implicit) + right-hand side ----------------
  float rhs[NV];
#pragma unroll
  for (int j = 0; j < 6; ++j) rhs[j] = -C[j];
  const float limit_k = T[O_LIMIT_K], limit_damp = T[O_LIMIT_DAMP];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = 6 + j;
    const float qj = q[7 + j], qdj = qd[d];
    const float below = jmax(T[O_JNT_LO + j] - qj, 0.f);
    const float above = jmax(qj - T[O_JNT_HI + j], 0.f);
    const bool viol = below > 0.f || above > 0.f;
    const float t_lim = limit_k * (below - above);
    const float D = T[O_DAMPING + j] + (viol ? limit_damp : 0.f);
    const float K = viol ? limit_k : 0.f;
    float& Mjj = L[d * (d + 1) / 2 + d];
    Mjj = Mjj + T[O_ARMATURE + j];
    Mjj = Mjj + h * D + h2 * K;
    rhs[d] = tau[j] + t_lim - (D + h * K) * qdj - C[d];
  }

  // ---------------- 5. Cholesky solve ----------------
  float inv_diag[NV];
#pragma unroll
  for (int a = 0; a < NV; ++a) {
#pragma unroll
    for (int b2 = 0; b2 <= a; ++b2) {
      float s = L[a * (a + 1) / 2 + b2];
#pragma unroll
      for (int k = 0; k < b2; ++k) s = s - L[a * (a + 1) / 2 + k] * L[b2 * (b2 + 1) / 2 + k];
      if (a == b2) {
        const float d = sqrtf(jmax(s, 1e-12f));
        L[a * (a + 1) / 2 + a] = d;
        inv_diag[a] = 1.0f / d;
      } else {
        L[a * (a + 1) / 2 + b2] = s * inv_diag[b2];
      }
    }
  }
  float y[NV];
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    float s = rhs[a];
#pragma unroll
    for (int k = 0; k < a; ++k) s = s - L[a * (a + 1) / 2 + k] * y[k];
    y[a] = s * inv_diag[a];
  }
  float qacc[NV];
#pragma unroll
  for (int a = NV - 1; a >= 0; --a) {
    float s = y[a];
#pragma unroll
    for (int k = a + 1; k < NV; ++k) s = s - L[k * (k + 1) / 2 + a] * qacc[k];
    qacc[a] = s * inv_diag[a];
  }

  // ---------------- 6. integrate ----------------
  const float max_lin = T[O_MAX_LIN_VEL], max_ang = T[O_MAX_ANG_VEL], max_dof = T[O_MAX_DOF_VEL];
  float nqv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float lim = j < 3 ? max_lin : (j < 6 ? max_ang : max_dof);
    nqv[j] = jclip(qd[j] + h * qacc[j], -lim, lim);
    qvel_out[j * B + i] = nqv[j];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) qpos_out[k * B + i] = q[k] + h * nqv[k];
  Q4 dq; dq.x = nqv[3] * half_h; dq.y = nqv[4] * half_h; dq.z = nqv[5] * half_h; dq.w = 0.f;
  Q4 qn = qmul(dq, base_q);
  qn.x = base_q.x + qn.x; qn.y = base_q.y + qn.y; qn.z = base_q.z + qn.z; qn.w = base_q.w + qn.w;
  const float nrm = sqrtf(qn.x * qn.x + qn.y * qn.y + qn.z * qn.z + qn.w * qn.w + 1e-12f);
  const float inv = 1.0f / nrm;
  qpos_out[3 * B + i] = qn.x * inv;
  qpos_out[4 * B + i] = qn.y * inv;
  qpos_out[5 * B + i] = qn.z * inv;
  qpos_out[6 * B + i] = qn.w * inv;
#pragma unroll
  for (int j = 0; j < NJ; ++j) qpos_out[(7 + j) * B + i] = q[7 + j] + h * nqv[6 + j];

  // ---------------- 7. box wrench ----------------
#pragma unroll
  for (int k = 0; k < 6; ++k) wrench_out[k * B + i] = box_wrench[k];
}

}  // namespace

extern "C" int substep_table_len(int P) { return FIXED_LEN + 6 * P; }

// Launches on `stream`; allocates nothing.  Returns cudaGetLastError().
extern "C" int substep_launch(const void* table, int table_len, int P, int num_ants, int B, int E,
                              const void* qpos, const void* qvel, const void* tau,
                              const void* box_qpos, const void* box_qvel, void* qpos_out,
                              void* qvel_out, void* wrench_out, void* sens_out, void* stream) {
  if (B > 0) {
    const int blocks = (B + THREADS - 1) / THREADS;
    substep_kernel<<<blocks, THREADS, table_len * sizeof(float), (cudaStream_t)stream>>>(
        (const float*)table, table_len, P, num_ants, B, E, (const float*)qpos, (const float*)qvel,
        (const float*)tau, (const float*)box_qpos, (const float*)box_qvel, (float*)qpos_out,
        (float*)qvel_out, (float*)wrench_out, (float*)sens_out);
  }
  return (int)cudaGetLastError();
}
