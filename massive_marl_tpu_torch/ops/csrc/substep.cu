// One physics substep for a batch of ant articulations, a team of four
// lanes of one warp per articulation (CUDA C++ for sm_90a).
//
// Replaces two TPU kernels with one templated body:
//   B1 massive_marl_tpu/ops/fused_substep.py:114 _substep_kernel (a
//      pallas_call whose body is massive_marl_tpu/ops/scalar_phys.py::substep
//      with _contact_force), launched by substep_launch as <LEGACY, true, DR>,
//      LEGACY from the table's flag (ContactParams.beta None), DR when the
//      caller passes the domain-randomization operand;
//   B6 scripts/debug_fused_tpu.py:134 kernel_fn (B1's body under beta=None,
//      without the sensor outputs, the box state given per articulation),
//      launched by debug_substep_launch as <true, false, false>.
// LEGACY selects the reference's explicit spring-damper contact branch
// (fn = max(kn depth - kd vn, 0), friction ramped over friction_vel), which
// reads no inverse inertia; SENSORS writes the foot-sensor wrenches.
//
// DR reads five parameter groups per articulation from one more [41, B]
// operand (mass [9], damping, armature, jnt_lo, jnt_hi [8 each], in the
// order of the reference's _dr_field_layout) where the other instantiations
// read the table, and recomputes what the table bakes from them: the inverse
// masses (true divisions), the armature-augmented inverse inertias of the
// bodies below the torso (the closed-form symmetric 3x3 inverse) and the
// composite masses (children into parents from the last body).
//
// The plain PyTorch version with the same arithmetic is
// massive_marl_tpu_torch/ops/scalar_phys.py::substep; both read the same
// flat constant table (scalar_phys.bake_consts), whose field order the O_*
// offsets below repeat.
//
// What bounds it on this card: per articulation it moves ~100 floats of
// state (about 16 MB at B = 40,960, ~5 us at 3.35 TB/s) but executes ~30k
// FP32 operations, so it is bound by operations.  Under -fmad=false, which
// keeps every rounding where the plain version has it, each operation is
// one instruction, so no build of it goes below about twice the operations
// bound.  A first version ran one articulation per thread: its tree was read
// from the table at run time, so every per-body array lived in local memory
// (255 registers and ~2.2 KB of stack a thread), two blocks fit on an SM and
// the spills went to L2.
//
// The design:
//   - The ant's tree is compiled in, as the TPU kernel traces it with Python
//     ints: PARENT, POINT_START, CHAIN_MASK, BODY_OF_DOF and BODY_SENSOR
//     below, checked by static_asserts against the team's split (the wrapper
//     refuses a table baked from another tree).  Every register array is
//     indexed statically; nothing lives in local memory.
//   - A team of four lanes of one warp per articulation; lane l owns leg l:
//     bodies 2l+1 and 2l+2 (their kinematics, velocities, six contact
//     points, composite inertias and bias forces, and mass-matrix rows 6+2l
//     and 7+2l).  The torso's kinematics and dynamics are computed by every
//     lane alike; its 13 contact points go round the team (point 4s+l in
//     slot s), and its six mass-matrix rows are split between lanes.  Eight
//     lanes (one per leg body) were slower on this card (PERF.md): the
//     torso's work, done by every lane, weighs twice as much.
//   - State that more than one lane reads lives in shared memory, one
//     odd-strided record per articulation; the table is staged there once
//     per block.  The records (2 KB each) and ~165 registers a thread allow
//     6 blocks of 64 threads per SM.
//   - Every sum keeps the plain version's operands and order.  Sums across
//     lanes are taken in point order: the torso's force and the box wrench
//     over torso points through shuffles slot by slot, the box wrench over
//     leg points from shared memory, one wrench component per lane.
//     Children go into parents from the last body (the torso takes bodies
//     7, 5, 3, 1 in that order).  The Cholesky factor is computed a column
//     at a time, the column's rows split between lanes, each entry with its
//     own sum in the plain order; the triangular solves run on every lane
//     alike.
//   - Structural zeros of the mass matrix stay exactly 0 (the factor fills
//     in through the base dofs, as the plain version's does).
//   - A tail mask replaces the TPU version's padding: lanes past B compute
//     on the last articulation and store nothing, so every lane reaches
//     every __syncwarp.
//
// NaN semantics follow jnp.maximum/minimum/clip (NaN propagates), so a
// blown-up articulation stays non-finite and the environment's blow-up
// check resets it exactly as in the reference.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 9;   // bodies
constexpr int NJ = 8;   // hinges
constexpr int NV = 14;  // dofs
constexpr int NS = 4;   // foot sensors
constexpr int NL = NV * (NV + 1) / 2;  // packed lower triangle
constexpr int NP = 37;  // contact points

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
constexpr int O_LEGACY = O_ACC_UNITS + 1;
constexpr int O_FRICTION_VEL = O_LEGACY + 1;
constexpr int O_LIMIT_K = O_FRICTION_VEL + 1;
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

// ---- DR operand fields (ops/fused_substep.py::DR_LAYOUT) ----
constexpr int D_MASS = 0;
constexpr int D_DAMPING = D_MASS + NB;
constexpr int D_ARMATURE = D_DAMPING + NJ;
constexpr int D_JNT_LO = D_ARMATURE + NJ;
constexpr int D_JNT_HI = D_JNT_LO + NJ;
constexpr int DR_LEN = D_JNT_HI + NJ;

constexpr int TABLE_LEN = FIXED_LEN + 6 * NP;

// ---- the ant's tree, compiled in (ops/fused_substep.py::KERNEL_TREE) ----
constexpr int PARENT[NB] = {-1, 0, 1, 0, 3, 0, 5, 0, 7};
constexpr int POINT_START[NB + 1] = {0, 13, 16, 19, 22, 25, 28, 31, 34, 37};
constexpr int CHAIN_MASK[NV] = {1, 3, 7, 15, 31, 63, 127, 255, 319, 831, 1087, 3135, 4159, 12351};
constexpr int BODY_OF_DOF[NV] = {0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8};
constexpr int BODY_SENSOR[NB] = {-1, -1, 0, -1, 1, -1, 2, -1, 3};

constexpr int TEAM = 4;                 // lanes per articulation: one per leg
constexpr int TORSO_PTS = POINT_START[1];
constexpr int LEG_PTS = 3;              // per leg body
constexpr int TORSO_SLOTS = (TORSO_PTS + TEAM - 1) / TEAM;

// the split below assumes leg l = bodies 2l+1 (on the torso) and 2l+2 (the
// foot, carrying sensor l), hinge dofs 6+2l and 7+2l, LEG_PTS points each
constexpr bool tree_is_four_legs() {
  if (PARENT[0] != -1 || BODY_SENSOR[0] != -1 || POINT_START[0] != 0 || POINT_START[NB] != NP)
    return false;
  for (int j = 0; j < 6; ++j)
    if (BODY_OF_DOF[j] != 0 || CHAIN_MASK[j] != (1 << (j + 1)) - 1) return false;
  for (int l = 0; l < TEAM; ++l) {
    const int u = 2 * l + 1, w = 2 * l + 2, du = 6 + 2 * l, dw = 7 + 2 * l;
    if (PARENT[u] != 0 || PARENT[w] != u || BODY_SENSOR[u] != -1 || BODY_SENSOR[w] != l) return false;
    if (BODY_OF_DOF[du] != u || BODY_OF_DOF[dw] != w) return false;
    if (CHAIN_MASK[du] != (63 | (1 << du)) || CHAIN_MASK[dw] != (63 | (1 << du) | (1 << dw)))
      return false;
    if (POINT_START[u] != TORSO_PTS + 6 * l || POINT_START[w] != POINT_START[u] + LEG_PTS ||
        POINT_START[w + 1] != POINT_START[w] + LEG_PTS)
      return false;
  }
  return true;
}
static_assert(NB == 1 + 2 * TEAM && NJ == 2 * TEAM && NS == TEAM, "one lane per leg");
static_assert(tree_is_four_legs(), "the team's split does not match the compiled tree");

// ---- the per-articulation record in shared memory (floats) ----
// kept to the end: body origins, rotations, spatial velocities, centres of
// mass, and the hinge dofs' motion subspaces
constexpr int S_POS = 0;                 // [NB][3]
constexpr int S_R = S_POS + NB * 3;      // [NB][9]
constexpr int S_V = S_R + NB * 9;        // [NB][6]
constexpr int S_COM = S_V + NB * 6;      // [NB][3]
constexpr int S_PHI = S_COM + NB * 3;    // [NJ][6]
// the contact phase's: world inverse inertias and inverse masses (implicit
// branch), the box's pose, velocity and world inverse inertia, the torso
// points' sums, the leg points' box-wrench terms
constexpr int S_IINV = S_PHI + NJ * 6;   // [NB][9]
constexpr int S_IM = S_IINV + NB * 9;    // [NB]
constexpr int S_BOX = S_IM + NB;         // bp 3, bR 9, bv 3, bw 3, bIw 9
constexpr int S_ACC = S_BOX + 27;        // torso force 6, box wrench over torso points 6
constexpr int S_BT = S_ACC + 12;         // [NP - TORSO_PTS][6]
constexpr int S_END = S_BT + (NP - TORSO_PTS) * 6;
// the dynamics phase's, over the contact phase's: each upper leg body's
// composite (A 9, B 9, force 6, mass), the mass matrix / factor, the
// right-hand side
constexpr int S_X = S_IINV;              // [TEAM][25]
constexpr int S_L = S_X + TEAM * 25;     // [NL]
constexpr int S_RHS = S_L + NL;          // [NV]
static_assert(S_RHS + NV <= S_END, "dynamics scratch overruns the record");
constexpr int ART_STRIDE = S_END | 1;    // odd: a warp's eight records start on distinct banks

constexpr int THREADS = 64;
constexpr int ARTS = THREADS / TEAM;     // articulations per block
constexpr size_t SMEM_BYTES = (size_t)(TABLE_LEN + ARTS * ART_STRIDE) * sizeof(float);

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

// inverse of K + arm * 1 for a symmetric row-major K (scalar_phys's
// _inv3x3_sym_t, operation for operation), row-major into out
__device__ __forceinline__ void inv3x3_sym_aug(const float* K, float arm, float* out) {
  const float a = K[0] + arm, b = K[1], c = K[2];
  const float d = K[4] + arm, e = K[5];
  const float f = K[8] + arm;
  const float A = d * f - e * e;
  const float B = c * e - b * f;
  const float C = b * e - c * d;
  const float det = a * A + b * B + c * C;
  const float D = a * f - c * c;
  const float E = b * c - a * e;
  const float F = a * d - b * b;
  const float inv = 1.0f / det;
  out[0] = A * inv; out[1] = B * inv; out[2] = C * inv;
  out[3] = B * inv; out[4] = D * inv; out[5] = E * inv;
  out[6] = C * inv; out[7] = E * inv; out[8] = F * inv;
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

struct Contact { float h, kn, kd, mdv, hc_vel, hc_cap, fv; bool acc_units; };

// LEGACY: the explicit spring-damper with friction ramped over fv, which
// never evaluates w
template <bool LEGACY>
__device__ __forceinline__ V3 contact_force(float depth, V3 n, V3 v_rel, float mu,
                                            const WFn& w, const Contact& c) {
  const float active = depth > 0.f ? 1.f : 0.f;
  const float vn = dot(v_rel, n);
  const V3 vt = sub(v_rel, scale(n, vn));
  const float vt_norm = sqrtf(dot(vt, vt) + 1e-12f);
  if constexpr (LEGACY) {
    const float fn = jmax(c.kn * depth - c.kd * vn, 0.f) * active;
    const float ft = jmin(mu * fn, mu * fn * vt_norm / c.fv);
    return sub(scale(n, fn), scale(vt, ft / vt_norm));
  } else {
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
}

__device__ __forceinline__ V3 ld3(const float* p) { return v3(p[0], p[1], p[2]); }
__device__ __forceinline__ void st3(float* p, V3 a) { p[0] = a.x; p[1] = a.y; p[2] = a.z; }
__device__ __forceinline__ M33 ld9(const float* p) {
  M33 r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.m[k / 3][k % 3] = p[k];
  return r;
}
__device__ __forceinline__ void st9(float* p, const M33& a) {
#pragma unroll
  for (int k = 0; k < 9; ++k) p[k] = a.m[k / 3][k % 3];
}
__device__ __forceinline__ S6 ld6(const float* p) {
  S6 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.a[k] = p[k];
  return r;
}
__device__ __forceinline__ void st6(float* p, const S6& a) {
#pragma unroll
  for (int k = 0; k < 6; ++k) p[k] = a.a[k];
}
__device__ __forceinline__ S6 zero6() { return make6(v3(0.f, 0.f, 0.f), v3(0.f, 0.f, 0.f)); }
// the motion subspace of base dof j < 6: linear x, y, z, then angular x, y, z
__device__ __forceinline__ S6 base_phi(int j) {
  const int one = j < 3 ? j + 3 : j - 3;
  S6 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.a[k] = k == one ? 1.f : 0.f;
  return r;
}

template <bool LEGACY, bool SENSORS, bool DR>
__global__ void __launch_bounds__(THREADS)
substep_kernel(const float* __restrict__ table, int num_ants, int B, int E,
               const float* __restrict__ dr, const float* __restrict__ qpos_in,
               const float* __restrict__ qvel_in, const float* __restrict__ tau_in,
               const float* __restrict__ box_qpos_in, const float* __restrict__ box_qvel_in,
               float* __restrict__ qpos_out, float* __restrict__ qvel_out,
               float* __restrict__ wrench_out, float* __restrict__ sens_out) {
  extern __shared__ float smem[];
  float* const T = smem;
  for (int k = threadIdx.x; k < TABLE_LEN; k += THREADS) T[k] = table[k];
  __syncthreads();
  const int l = threadIdx.x % TEAM;  // this lane's leg
  float* const S = smem + TABLE_LEN + (threadIdx.x / TEAM) * ART_STRIDE;
  const int i_team = blockIdx.x * ARTS + threadIdx.x / TEAM;
  const bool live = i_team < B;
  const int i = live ? i_team : B - 1;  // past B: compute on the last articulation, store nothing
  // a per-articulation parameter: field k of the DR operand, else the table's
  auto param = [&](int k, float nominal) -> float {
    if constexpr (DR) return __ldg(dr + k * B + i);
    else return nominal;
  };
  const int u = 2 * l + 1, w = 2 * l + 2;  // the leg's bodies: on the torso, the foot
  const int ju = 2 * l, jw = 2 * l + 1;    // their hinges
  const int du = 6 + ju, dw = 6 + jw;      // and dofs

  const float* point_local = T + FIXED_LEN;
  const float* point_radius = point_local + 3 * NP;
  const float* mu_plane = point_radius + NP;
  const float* mu_box = mu_plane + NP;
  const bool has_box = T[O_HAS_BOX] != 0.f;
  const float h = T[O_H], h2 = T[O_H2], half_h = T[O_HALF_H];
  Contact cp;
  cp.h = h; cp.kn = T[O_KN]; cp.kd = T[O_KD]; cp.mdv = T[O_MAX_DEPEN_VEL];
  cp.hc_vel = T[O_HC_VEL]; cp.hc_cap = T[O_HC_CAP]; cp.acc_units = T[O_ACC_UNITS] != 0.f;
  cp.fv = T[O_FRICTION_VEL];

  float qb[7], qdb[6];
#pragma unroll
  for (int k = 0; k < 7; ++k) qb[k] = qpos_in[k * B + i];
#pragma unroll
  for (int k = 0; k < 6; ++k) qdb[k] = qvel_in[k * B + i];
  const float q_u = qpos_in[(7 + ju) * B + i], q_w = qpos_in[(7 + jw) * B + i];
  const float qd_u = qvel_in[du * B + i], qd_w = qvel_in[dw * B + i];
  const float tau_u = tau_in[ju * B + i], tau_w = tau_in[jw * B + i];
  const V3 base = v3(qb[0], qb[1], qb[2]);
  Q4 base_q; base_q.x = qb[3]; base_q.y = qb[4]; base_q.z = qb[5]; base_q.w = qb[6];

  // ---------------- 1. forward kinematics and velocities ----------------
  {
    const M33 R0 = qmat(base_q);
    const S6 v0 = make6(v3(qdb[3], qdb[4], qdb[5]), v3(qdb[0], qdb[1], qdb[2]));
    if (l == 0) {
      st3(S + S_POS, base);
      st9(S + S_R, R0);
      st6(S + S_V, v0);
      st3(S + S_COM, add(base, mv(R0, load3(T + O_COM))));
      if constexpr (!LEGACY) {
        st9(S + S_IINV, rotate_tensor(R0, T + O_INERTIA_INV_AUG));
        if constexpr (DR) S[S_IM] = 1.0f / __ldg(dr + D_MASS * B + i);
        else S[S_IM] = T[O_INV_MASS];
      }
    }
    // the leg: its upper body from the torso, then the foot from it
    V3 p_p = base;
    Q4 q_p = base_q;
    S6 v_p = v0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int b = u + k, j = ju + k;
      const float qj = k == 0 ? q_u : q_w, qdj = k == 0 ? qd_u : qd_w;
      const V3 p0 = add(p_p, qrot(q_p, load3(T + O_BODY_POS + 3 * b)));
      Q4 bq; bq.x = T[O_BODY_QUAT + 4 * b]; bq.y = T[O_BODY_QUAT + 4 * b + 1];
      bq.z = T[O_BODY_QUAT + 4 * b + 2]; bq.w = T[O_BODY_QUAT + 4 * b + 3];
      const Q4 q0 = qmul(q_p, bq);
      const V3 n_w = qrot(q0, load3(T + O_JNT_AXIS + 3 * j));
      const float half = 0.5f * qj;
      const float s = sinf(half);
      Q4 q_rot; q_rot.x = n_w.x * s; q_rot.y = n_w.y * s; q_rot.z = n_w.z * s; q_rot.w = cosf(half);
      const Q4 q_c = qmul(q_rot, q0);
      const V3 jp = load3(T + O_JNT_POS + 3 * j);
      const V3 anchor = add(p0, qrot(q0, jp));
      const V3 pos = sub(anchor, qrot(q_c, jp));
      const S6 phi = make6(n_w, cross(sub(anchor, base), n_w));
      const M33 R = qmat(q_c);
      S6 vb;
#pragma unroll
      for (int c = 0; c < 6; ++c) vb.a[c] = v_p.a[c] + phi.a[c] * qdj;
      st3(S + S_POS + 3 * b, pos);
      st9(S + S_R + 9 * b, R);
      st6(S + S_V + 6 * b, vb);
      st3(S + S_COM + 3 * b, add(pos, mv(R, load3(T + O_COM + 3 * b))));
      st6(S + S_PHI + 6 * j, phi);
      if constexpr (!LEGACY && DR) {
        float K[9];
        inv3x3_sym_aug(T + O_INERTIA + 9 * b, __ldg(dr + (D_ARMATURE + b - 1) * B + i), K);
        st9(S + S_IINV + 9 * b, rotate_tensor(R, K));
        S[S_IM + b] = 1.0f / __ldg(dr + (D_MASS + b) * B + i);
      } else if constexpr (!LEGACY) {
        st9(S + S_IINV + 9 * b, rotate_tensor(R, T + O_INERTIA_INV_AUG + 9 * b));
        S[S_IM + b] = T[O_INV_MASS + b];
      }
      p_p = pos;
      q_p = q_c;
      v_p = vb;
    }
  }
  if (has_box && l == 0) {
    const int env = i / num_ants;
    Q4 bq;
    bq.x = box_qpos_in[3 * E + env]; bq.y = box_qpos_in[4 * E + env];
    bq.z = box_qpos_in[5 * E + env]; bq.w = box_qpos_in[6 * E + env];
    const M33 bR = qmat(bq);
    st3(S + S_BOX, v3(box_qpos_in[env], box_qpos_in[E + env], box_qpos_in[2 * E + env]));
    st9(S + S_BOX + 3, bR);
    st3(S + S_BOX + 12, v3(box_qvel_in[env], box_qvel_in[E + env], box_qvel_in[2 * E + env]));
    st3(S + S_BOX + 15, v3(box_qvel_in[3 * E + env], box_qvel_in[4 * E + env], box_qvel_in[5 * E + env]));
    if constexpr (!LEGACY) st9(S + S_BOX + 18, rotate_tensor(bR, T + O_BOX_INV_INERTIA));
  }
  __syncwarp();

  // ---------------- 2. contacts ----------------
  // point p on body b: its world position, its force (plane plus box) and
  // its term of the box wrench about the box origin
  auto contact_point = [&](int p, int b, V3& p_w, V3& f_pt, S6& box_term) {
    const M33 Rb = ld9(S + S_R + 9 * b);
    const S6 vb = ld6(S + S_V + 6 * b);
    const float radius = point_radius[p];
    p_w = add(ld3(S + S_POS + 3 * b), mv(Rb, load3(point_local + 3 * p)));
    const V3 v_w = add(lin(vb), cross(ang(vb), sub(p_w, base)));
    WFn wf;
    if constexpr (!LEGACY) {
      wf.r = sub(p_w, ld3(S + S_COM + 3 * b));
      wf.I = ld9(S + S_IINV + 9 * b);
      wf.im = S[S_IM + b];
    }
    wf.two = false;
    f_pt = contact_force<LEGACY>(radius - p_w.z, v3(0.f, 0.f, 1.f), v_w, mu_plane[p], wf, cp);
    box_term = zero6();
    if (has_box) {
      const V3 bp = ld3(S + S_BOX), bv = ld3(S + S_BOX + 12), bw = ld3(S + S_BOX + 15);
      const M33 bR = ld9(S + S_BOX + 3);
      const V3 he = load3(T + O_BOX_HE);
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
      if constexpr (!LEGACY) {
        wf.two = true; wf.rb = r_box; wf.bI = ld9(S + S_BOX + 18); wf.bim = T[O_BOX_INV_MASS];
      }
      const V3 f_bx = contact_force<LEGACY>(depth_b, n_w, v_rel, mu_box[p], wf, cp);
      f_pt = add(f_pt, f_bx);
      const V3 tq = cross(r_box, f_bx);
      box_term = make6(v3(-tq.x, -tq.y, -tq.z), v3(-f_bx.x, -f_bx.y, -f_bx.z));
    }
  };

  // the torso's points round the team, point TEAM s + l in slot s; each
  // slot's terms reach every lane by shuffles and are summed in point order
  {
    S6 acc_f = zero6(), acc_b = zero6();
#pragma unroll 1
    for (int s = 0; s < TORSO_SLOTS; ++s) {
      S6 ft = zero6(), bt = zero6();
      if (TEAM * s + l < TORSO_PTS) {
        V3 p_w, f_pt;
        contact_point(TEAM * s + l, 0, p_w, f_pt, bt);
        ft = make6(cross(sub(p_w, base), f_pt), f_pt);
      }
#pragma unroll
      for (int src = 0; src < TEAM; ++src) {
        const bool in = TEAM * s + src < TORSO_PTS;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float x = __shfl_sync(0xffffffffu, ft.a[c], src, TEAM);
          if (in) acc_f.a[c] = acc_f.a[c] + x;
        }
        if (has_box) {
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            const float x = __shfl_sync(0xffffffffu, bt.a[c], src, TEAM);
            if (in) acc_b.a[c] = acc_b.a[c] + x;
          }
        }
      }
    }
    if (l == 0) {
      st6(S + S_ACC, acc_f);
      st6(S + S_ACC + 6, acc_b);
    }
  }
  // the leg's own points: the upper body's, then the foot's
  V3 fu_t = v3(0.f, 0.f, 0.f), fu_f = fu_t, fw_t = fu_t, fw_f = fu_t, f_sum = fu_t, t_sum = fu_t;
#pragma unroll 1
  for (int k = 0; k < 2 * LEG_PTS; ++k) {
    const bool foot = k >= LEG_PTS;
    const int lp = 2 * LEG_PTS * l + k;  // the point's index among the leg points
    V3 p_w, f_pt;
    S6 bt;
    contact_point(TORSO_PTS + lp, foot ? w : u, p_w, f_pt, bt);
    if (has_box) st6(S + S_BT + 6 * lp, bt);
    const V3 tq = cross(sub(p_w, base), f_pt);
    if (foot) {
      fw_t = add(fw_t, tq);
      fw_f = add(fw_f, f_pt);
      if constexpr (SENSORS) {
        f_sum = add(f_sum, f_pt);
        t_sum = add(t_sum, cross(sub(p_w, ld3(S + S_POS + 3 * w)), f_pt));
      }
    } else {
      fu_t = add(fu_t, tq);
      fu_f = add(fu_f, f_pt);
    }
  }
  if constexpr (SENSORS) {  // the foot carries sensor l
    const M33 Rw = ld9(S + S_R + 9 * w);
    const V3 fl = mtv(Rw, f_sum), tl = mtv(Rw, t_sum);
    if (live) {
      float* o = sens_out + (6 * l) * B + i;
      o[0] = fl.x; o[B] = fl.y; o[2 * B] = fl.z; o[3 * B] = tl.x; o[4 * B] = tl.y; o[5 * B] = tl.z;
    }
  }
  __syncwarp();
  // the box wrench, one component per lane, over every point in order
  const S6 f_torso = ld6(S + S_ACC);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int c = l + TEAM * r;
    if (c < 6) {
      float acc = 0.f;
      if (has_box) {
        acc = S[S_ACC + 6 + c];
#pragma unroll
        for (int lp = 0; lp < NP - TORSO_PTS; ++lp) acc = acc + S[S_BT + 6 * lp + c];
      }
      if (live) wrench_out[c * B + i] = acc;
    }
  }
  __syncwarp();

  // ---------------- 4. bias forces, then CRBA composite inertias ----------------
  const V3 grav = load3(T + O_GRAVITY);
  // body b's spatial inertia about the base point and its force: bias minus
  // gravity minus the contact force f_b
  auto body_dyn = [&](int b, const S6& vb, const S6& avp, const S6& f_b, SpI& I, S6& fs) {
    const M33 Iw = rotate_tensor(ld9(S + S_R + 9 * b), T + O_INERTIA + 9 * b);
    const V3 cr = sub(ld3(S + S_COM + 3 * b), base);
    const float m = param(D_MASS + b, T[O_MASS + b]);
    M33 cx;
    cx.m[0][0] = 0.f; cx.m[0][1] = -cr.z; cx.m[0][2] = cr.y;
    cx.m[1][0] = cr.z; cx.m[1][1] = 0.f; cx.m[1][2] = -cr.x;
    cx.m[2][0] = -cr.y; cx.m[2][1] = cr.x; cx.m[2][2] = 0.f;
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
    const S6 t1 = imv(I, avp);
    const S6 t2 = force_cross(vb, imv(I, vb));
#pragma unroll
    for (int k = 0; k < 6; ++k) fs.a[k] = (t1.a[k] + t2.a[k]) - f_grav.a[k] - f_b.a[k];
  };
  float* const L = S + S_L;  // packed lower triangle L[a (a + 1) / 2 + k], k <= a
  for (int k = l; k < NL; k += TEAM) L[k] = 0.f;  // the structural zeros
  const S6 v0 = ld6(S + S_V);
  const S6 avp0 = make6(v3(0.f, 0.f, 0.f), cross(v3(qdb[0], qdb[1], qdb[2]), v3(qdb[3], qdb[4], qdb[5])));
  const S6 phi_u = ld6(S + S_PHI + 6 * ju), phi_w = ld6(S + S_PHI + 6 * jw);
  const S6 v_u = ld6(S + S_V + 6 * u);
  SpI I_u, I_w;
  S6 fs_u, fs_w;
  {
    S6 vJ, avp_u, avp_w;
#pragma unroll
    for (int k = 0; k < 6; ++k) vJ.a[k] = phi_u.a[k] * qd_u;
    S6 mc = motion_cross(v0, vJ);
#pragma unroll
    for (int k = 0; k < 6; ++k) avp_u.a[k] = avp0.a[k] + mc.a[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) vJ.a[k] = phi_w.a[k] * qd_w;
    mc = motion_cross(v_u, vJ);
#pragma unroll
    for (int k = 0; k < 6; ++k) avp_w.a[k] = avp_u.a[k] + mc.a[k];
    body_dyn(w, ld6(S + S_V + 6 * w), avp_w, make6(fw_t, fw_f), I_w, fs_w);
    body_dyn(u, v_u, avp_u, make6(fu_t, fu_f), I_u, fs_u);
  }
  // the foot into its parent, then the leg into the torso
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      I_u.A.m[r][c] = I_u.A.m[r][c] + I_w.A.m[r][c];
      I_u.B.m[r][c] = I_u.B.m[r][c] + I_w.B.m[r][c];
    }
#pragma unroll
  for (int k = 0; k < 6; ++k) fs_u.a[k] = fs_u.a[k] + fs_w.a[k];
  if constexpr (DR) I_u.m = I_u.m + I_w.m;
  {
    float* X = S + S_X + 25 * l;
    st9(X, I_u.A);
    st9(X + 9, I_u.B);
    st6(X + 18, fs_u);
    X[24] = I_u.m;
  }
  SpI I0;
  S6 fs0;
  body_dyn(0, v0, avp0, f_torso, I0, fs0);
  __syncwarp();
  // the torso takes bodies 7, 5, 3, 1 in that order (children into parents
  // from the last body)
#pragma unroll
  for (int t = TEAM - 1; t >= 0; --t) {
    const float* X = S + S_X + 25 * t;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        I0.A.m[r][c] = I0.A.m[r][c] + X[3 * r + c];
        I0.B.m[r][c] = I0.B.m[r][c] + X[9 + 3 * r + c];
      }
#pragma unroll
    for (int k = 0; k < 6; ++k) fs0.a[k] = fs0.a[k] + X[18 + k];
    if constexpr (DR) I0.m = I0.m + X[24];
  }
  if constexpr (!DR) {
    I0.m = T[O_COMP_MASS];
    I_u.m = T[O_COMP_MASS + u];
    I_w.m = T[O_COMP_MASS + w];
  }

  // mass matrix and right-hand side: the torso's rows l and 5 - l on lanes
  // 0-2, the leg's rows 6 + 2l and 7 + 2l on lane l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = r == 0 ? l : 5 - l;
    if (l < 3) {
      const S6 phi_j = base_phi(j);
      const S6 fI = imv(I0, phi_j);
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (k <= j) L[j * (j + 1) / 2 + k] = dot6(base_phi(k), fI);
      S[S_RHS + j] = -dot6(phi_j, fs0);
    }
  }
  {
    const float limit_k = T[O_LIMIT_K], limit_damp = T[O_LIMIT_DAMP];
    // the implicit joint limit of hinge j: folds into M_jj, returns the
    // right-hand side
    auto hinge = [&](int j, float qj, float qdj, float tau, float C, float& Mjj) -> float {
      const float below = jmax(param(D_JNT_LO + j, T[O_JNT_LO + j]) - qj, 0.f);
      const float above = jmax(qj - param(D_JNT_HI + j, T[O_JNT_HI + j]), 0.f);
      const bool viol = below > 0.f || above > 0.f;
      const float t_lim = limit_k * (below - above);
      const float D = param(D_DAMPING + j, T[O_DAMPING + j]) + (viol ? limit_damp : 0.f);
      const float K = viol ? limit_k : 0.f;
      Mjj = Mjj + param(D_ARMATURE + j, T[O_ARMATURE + j]);
      Mjj = Mjj + h * D + h2 * K;
      return tau + t_lim - (D + h * K) * qdj - C;
    };
    float* Lu = L + du * (du + 1) / 2;
    float* Lw = L + dw * (dw + 1) / 2;
    const S6 fIu = imv(I_u, phi_u);
#pragma unroll
    for (int k = 0; k < 6; ++k) Lu[k] = dot6(base_phi(k), fIu);
    float Muu = dot6(phi_u, fIu);
    S[S_RHS + du] = hinge(ju, q_u, qd_u, tau_u, dot6(phi_u, fs_u), Muu);
    Lu[du] = Muu;
    const S6 fIw = imv(I_w, phi_w);
#pragma unroll
    for (int k = 0; k < 6; ++k) Lw[k] = dot6(base_phi(k), fIw);
    Lw[du] = dot6(phi_u, fIw);
    float Mww = dot6(phi_w, fIw);
    S[S_RHS + dw] = hinge(jw, q_w, qd_w, tau_w, dot6(phi_w, fs_w), Mww);
    Lw[dw] = Mww;
  }
  __syncwarp();

  // ---------------- 5. Cholesky solve ----------------
  // a column at a time: its diagonal on every lane alike, its rows below
  // split between the lanes
  float inv_diag[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const float* Lc = L + c * (c + 1) / 2;
    float s = Lc[c];
#pragma unroll
    for (int k = 0; k < c; ++k) s = s - Lc[k] * Lc[k];
    inv_diag[c] = 1.0f / sqrtf(jmax(s, 1e-12f));
#pragma unroll
    for (int r = 0; r < (NV - 1 - c + TEAM - 1) / TEAM; ++r) {
      const int a = c + 1 + l + TEAM * r;
      if (a < NV) {
        float* La = L + a * (a + 1) / 2;
        float s2 = La[c];
#pragma unroll
        for (int k = 0; k < c; ++k) s2 = s2 - La[k] * Lc[k];
        La[c] = s2 * inv_diag[c];
      }
    }
    __syncwarp();
  }
  float y[NV];
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    float s = S[S_RHS + a];
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
  if (!live) return;
  if (l == 0) {
    float nqv[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float lim = j < 3 ? max_lin : max_ang;
      nqv[j] = jclip(qdb[j] + h * qacc[j], -lim, lim);
      qvel_out[j * B + i] = nqv[j];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) qpos_out[k * B + i] = qb[k] + h * nqv[k];
    Q4 dq; dq.x = nqv[3] * half_h; dq.y = nqv[4] * half_h; dq.z = nqv[5] * half_h; dq.w = 0.f;
    Q4 qn = qmul(dq, base_q);
    qn.x = base_q.x + qn.x; qn.y = base_q.y + qn.y; qn.z = base_q.z + qn.z; qn.w = base_q.w + qn.w;
    const float nrm = sqrtf(qn.x * qn.x + qn.y * qn.y + qn.z * qn.z + qn.w * qn.w + 1e-12f);
    const float inv = 1.0f / nrm;
    qpos_out[3 * B + i] = qn.x * inv;
    qpos_out[4 * B + i] = qn.y * inv;
    qpos_out[5 * B + i] = qn.z * inv;
    qpos_out[6 * B + i] = qn.w * inv;
  }
  // the leg's hinges (qacc picked by a static index)
  float acc_u = 0.f, acc_w = 0.f;
#pragma unroll
  for (int k = 0; k < TEAM; ++k)
    if (k == l) { acc_u = qacc[6 + 2 * k]; acc_w = qacc[7 + 2 * k]; }
  const float nqv_u = jclip(qd_u + h * acc_u, -max_dof, max_dof);
  const float nqv_w = jclip(qd_w + h * acc_w, -max_dof, max_dof);
  qvel_out[du * B + i] = nqv_u;
  qvel_out[dw * B + i] = nqv_w;
  qpos_out[(7 + ju) * B + i] = q_u + h * nqv_u;
  qpos_out[(7 + jw) * B + i] = q_w + h * nqv_w;
}

}  // namespace

extern "C" int substep_table_len(int P) { return FIXED_LEN + 6 * P; }

namespace {
static_assert(SMEM_BYTES <= 48 * 1024, "dynamic shared memory above 48 KB needs an attribute");

template <bool LEGACY, bool SENSORS, bool DR>
void launch(const void* table, int num_ants, int B, int E, const void* dr, const void* qpos,
            const void* qvel, const void* tau, const void* box_qpos, const void* box_qvel,
            void* qpos_out, void* qvel_out, void* wrench_out, void* sens_out, void* stream) {
  const int blocks = (B + ARTS - 1) / ARTS;
  substep_kernel<LEGACY, SENSORS, DR><<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)table, num_ants, B, E, (const float*)dr, (const float*)qpos,
      (const float*)qvel, (const float*)tau, (const float*)box_qpos, (const float*)box_qvel,
      (float*)qpos_out, (float*)qvel_out, (float*)wrench_out, (float*)sens_out);
}
}  // namespace

// Launches on `stream`; allocates nothing.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a table not of the compiled size (P contact
// points).  B1: `legacy` is the table's legacy flag (the caller's host copy
// of it); `dr` is the [DR_LEN, B] domain-randomization operand, or null for
// the table's parameters.
extern "C" int substep_launch(const void* table, int table_len, int P, int num_ants, int B, int E,
                              int legacy, const void* dr, const void* qpos, const void* qvel,
                              const void* tau, const void* box_qpos, const void* box_qvel,
                              void* qpos_out, void* qvel_out, void* wrench_out, void* sens_out,
                              void* stream) {
  if (P != NP || table_len != TABLE_LEN) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    if (legacy && dr)
      launch<true, true, true>(table, num_ants, B, E, dr, qpos, qvel, tau, box_qpos, box_qvel,
                               qpos_out, qvel_out, wrench_out, sens_out, stream);
    else if (legacy)
      launch<true, true, false>(table, num_ants, B, E, dr, qpos, qvel, tau, box_qpos, box_qvel,
                                qpos_out, qvel_out, wrench_out, sens_out, stream);
    else if (dr)
      launch<false, true, true>(table, num_ants, B, E, dr, qpos, qvel, tau, box_qpos, box_qvel,
                                qpos_out, qvel_out, wrench_out, sens_out, stream);
    else
      launch<false, true, false>(table, num_ants, B, E, dr, qpos, qvel, tau, box_qpos, box_qvel,
                                 qpos_out, qvel_out, wrench_out, sens_out, stream);
  }
  return (int)cudaGetLastError();
}

// B6: the legacy branch without sensors, one box state per articulation
// (box_qpos [7, B], box_qvel [6, B]).  The table must carry the legacy flag.
extern "C" int debug_substep_launch(const void* table, int table_len, int P, int B,
                                    const void* qpos, const void* qvel, const void* tau,
                                    const void* box_qpos, const void* box_qvel, void* qpos_out,
                                    void* qvel_out, void* wrench_out, void* stream) {
  if (P != NP || table_len != TABLE_LEN) return (int)cudaErrorInvalidValue;
  if (B > 0)
    launch<true, false, false>(table, 1, B, B, nullptr, qpos, qvel, tau, box_qpos, box_qvel,
                               qpos_out, qvel_out, wrench_out, nullptr, stream);
  return (int)cudaGetLastError();
}

// Threads per block of every instantiation (TEAM lanes per articulation).
extern "C" int substep_threads_per_block() { return THREADS; }

// Resident blocks per SM of one instantiation (cudaOccupancyMaxActiveBlocks-
// PerMultiprocessor at the launch's block and shared-memory size): 0 B1, 1
// its legacy branch, 2 B1-DR, 3 B1-DR's legacy branch, 4 B6.  A negative
// value is a CUDA error, negated.
extern "C" int substep_blocks_per_sm(int which) {
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (which) {
    case 0: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, substep_kernel<false, true, false>, THREADS, SMEM_BYTES); break;
    case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, substep_kernel<true, true, false>, THREADS, SMEM_BYTES); break;
    case 2: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, substep_kernel<false, true, true>, THREADS, SMEM_BYTES); break;
    case 3: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, substep_kernel<true, true, true>, THREADS, SMEM_BYTES); break;
    case 4: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, substep_kernel<true, false, false>, THREADS, SMEM_BYTES); break;
    default: break;
  }
  return err == cudaSuccess ? n : -(int)err;
}
