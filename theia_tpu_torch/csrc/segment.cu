// The flagship's forward segment: four kernels for the per-lane code that
// theia_tpu leaves to XLA to fuse.
//
// Replaces theia_tpu/trace/scene.py SceneForwardTracer._segment_body (l.462,
// one XLA program under the jax.jit of _trace_batch, l.235), on the
// configuration that bench.py and __graft_entry__._build_scene_tracer
// build: a SphereTargetGuide's MIS, a fused histogram record, unpolarized,
// Philox, brute-force or mt packs. The port's eager _segment runs that body
// as about 1,250 torch launches a segment; here it is four, with the
// existing kernels between them (trace/segment.py drives them):
//   K_pre      the health check (RayState.is_bad), the distance draw and
//              sample_scatter_length (trace/core.py:206), the guide's eval
//              (target.py SphereTargetGuide), the free-extension test and
//              the query's t_max;
//   (the nearest-hit scan: nearest_in_table or nearest_triangle_mt)
//   K_surface  the winner rebuilt from tri_data and inst_data by its index
//              (accel.py _reconstruct_hit), the extension propagated to its
//              hit (_propagate_to_hit), propagate_ray, reattach_geometry and
//              update_ray_is (trace/core.py:257, 269, 238), the media
//              mismatch, _fresnel with the n_t read, the fused record's
//              item (_create_response_item, create_hit's time and
//              contribution), the surface draw, reflect or refract and
//              offset_ray, the new medium and its const4 constants
//              (material.py packed_medium_constants), and the result codes,
//              alive and allow_response;
//   (the record: histogram_add)
//   K_scatter  on segments before the last: _mis_shadow's two draws of the
//              phase sample (_sample_phase_packed, ops/sampling.py
//              scatter_dir, ops/math3d.py local_frame), the guide's sample
//              and eval, _scatter_prob_packed, the two weights and the 2N
//              shadow rays; then the real ray's phase scatter. One kernel,
//              because both draw in a fixed order on the same lanes;
//   (the shadow query: target_in_table, or the full nearest hit on mt)
//   K_shadow   the 2N target hits rebuilt and _shadow_item's item;
//   (the record).
//
// Bit for bit. Each kernel equals its plain twin in trace/segment.py, which
// runs the eager segment's helpers in their op order, and so the staged
// route equals the eager one on the card. That takes the same float32 ops
// in the same order: built with -fmad=false (no product is contracted into
// a sum), IEEE division and square root (__fdiv_rn, __fsqrt_rn; torch's
// division, torch.sqrt), the libdevice functions that torch's CUDA kernels
// call (logf, log1pf, expf, sinf, cosf), constants as the float32 roundings
// of the Python ones (2 pi u is 6.2831855f * u), 1 / x as torch's
// reciprocal, torch.maximum and torch.clamp with their NaN rules. The
// zero-valued graph terms of the eager forward (reattach_geometry's dist -
// dist, the x - x of the sampled logs' corrections) are computed as they
// are there: they turn -0.0 into +0.0 and an infinite x into NaN. Every lane
// computes every branch's value as the eager code does before its
// torch.where picks one, so dead and masked lanes leave with the values that
// were selected for them (RayState.is_bad reads them in the next segment),
// and every lane draws at the dims the eager code draws at, its dim moving
// as merge_dim moves it.
//
// What bounds them on an H100: bytes, and latency. A lane of K_surface reads
// its state (72 bytes), the query's answer, a 128-byte tri_data row and a
// 128-byte inst_data row (the scene's 480 KB and 384 B stay in L2), and
// writes its new state and the record's item (some 85 bytes), against a few
// hundred float operations and two Philox draws; K_scatter draws eight
// Philox words a lane (ten rounds each). Design: a thread a lane, the
// lane's arithmetic in registers, the packed tables read through
// csrc/table_read.cuh's read_lane (the read kernels' own code), Philox
// through csrc/philox.cuh's PhiloxLane. Making them fast is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"
#include "table_read.cuh"

// A batch's constants, field for field trace/segment.py _Const; outside the
// unnamed namespace, so that the C entry points keep external linkage.
struct TheiaSegmentConst {
  TheiaTableSpec ior;        // _fresnel's n_t: the wavelength's bounds, two clips, null 1
  TheiaTableSpec constants;  // packed_medium_constants' (mu_a, mu_s, n, vg)
  TheiaTableSpec sampling;   // the phase sampling tables at u (null 0)
  TheiaTableSpec log_phase;  // the log phase function at 0.5 cos + 0.5 (null log 1/(4 pi))
  const int* sampling_sizes;
  const float* tri_data;   // (T, 32)
  const float* inst_data;  // (K, 32)
  const float* guide_position;  // (3,)
  const float* guide_radius;
  const float* scatter_coef;
  const float* max_time;
  const float* max_dist;
  const float* lower;  // (3,) the propagation box
  const float* upper;
  const int* target_id;
  uint32_t key[2];
  uint32_t counter[4];
  int volume_border;  // 0: disableVolumeBorder
  int transmission;   // 0: disableTransmission
};

// Every per-lane array a kernel reads or writes, field for field
// trace/segment.py _LANE_FIELDS (null where a kernel takes none); count is
// the lanes of the launch (K_shadow: the 2N shadow rays, the state read at
// lane i mod N).
struct TheiaSegmentLanes {
  float* position;
  float* direction;
  float* wavelength;
  float* time;
  float* lin;
  float* log;
  float* n;
  float* vg;
  float* mu_s;
  float* mu_e;
  int* medium;
  bool* alive;
  bool* allow;
  int* stream;
  int* dim;
  bool* pre_alive;
  float* t_max;
  float* sampled;
  bool* mis_ext;
  int* pre_dim;
  float* t_hit;
  int* tri;
  float* out_position;
  float* out_direction;
  float* out_time;
  float* out_lin;
  float* out_log;
  float* out_n;
  float* out_vg;
  float* out_mu_s;
  float* out_mu_e;
  int* out_medium;
  bool* out_alive;
  bool* out_allow;
  int* out_dim;
  bool* miss;
  float* value;
  float* item_time;
  bool* mask;
  int* object_id;
  float* shadow_origin;
  float* shadow_direction;
  float* shadow_t_max;
  float* shadow_lin;
  float* shadow_log;
  int* shadow_medium;
  bool* shadow_active;
  int count;
};

namespace {

using theia::PhiloxBase;
using theia::PhiloxLane;
using Const = TheiaSegmentConst;
using Lanes = TheiaSegmentLanes;

constexpr int kThreads = 256;

// trace/core.py EventResultCode
constexpr int kSuccess = 0, kScattered = 2, kHit = 3, kDetected = 4, kVolumeHit = 5;
constexpr int kLost = -1, kDecayed = -2, kAbsorbed = -3, kMediaMismatch = -11;
// material.py MaterialFlags, the forward's bits
constexpr int kBlack = 0x01, kDetector = 0x02, kNoReflect = 0x08, kNoTransmit = 0x20, kVolume = 0x80;
// float32 of 2 pi and of 1 / (4 pi), as torch rounds the Python constants
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv4Pi = 0.0795774715459476679f;

// ---- float32 as torch's CUDA ops compute it ----

__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fsqrt(float x) { return __fsqrt_rn(x); }
// 1 / x: torch's reciprocal, then the product by 1
__device__ __forceinline__ float recip(float x) { return __fdiv_rn(1.0f, x) * 1.0f; }
// torch.maximum: NaN-propagating
__device__ __forceinline__ float tmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}
// torch.clamp and torch.clamp_min with scalars: a NaN stays NaN
__device__ __forceinline__ float tclamp(float v, float lo, float hi) { return v != v ? v : fminf(fmaxf(v, lo), hi); }
__device__ __forceinline__ float tclamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
// torch.sign
__device__ __forceinline__ float tsign(float a) {
  return static_cast<float>(static_cast<int>(0.0f < a) - static_cast<int>(a < 0.0f));
}
// torch.nan_to_num(x, nan=0, posinf=0, neginf=0)
__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.0f; }
// ops/math3d.py sign_bit: +-1 from the sign bit
__device__ __forceinline__ float sign_bit(float f) {
  return __int_as_float((__float_as_int(f) & static_cast<int>(0x80000000u)) | 0x3F800000);
}
// target.py _sqrt_positive
__device__ __forceinline__ float sqrt_positive(float x) { return x > 0.0f ? fsqrt(x > 0.0f ? x : 1.0f) : 0.0f; }

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, long long i) { return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]}; }
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 row3(const float* r) { return V3{__ldg(r), __ldg(r + 1), __ldg(r + 2)}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) { return V3{s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 pick(bool c, V3 a, V3 b) { return c ? a : b; }
// the sums of ops/math3d.py, left to right
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// ops/math3d.py norm and normalize (the 1e-30 floor)
__device__ __forceinline__ float norm(V3 a) { return fsqrt(tclamp_min(dot(a, a), 1e-30f)); }
__device__ __forceinline__ V3 normalize(V3 a) {
  const float n = norm(a);
  return V3{fdiv(a.x, n), fdiv(a.y, n), fdiv(a.z, n)};
}
__device__ __forceinline__ bool finite3(V3 a) { return isfinite(a.x) && isfinite(a.y) && isfinite(a.z); }

// ops/math3d.py local_frame: (vx, vy) completing vz
__device__ __forceinline__ void local_frame(V3 vz, V3* vx, V3* vy) {
  const float s = sign_bit(vz.z);
  const float a = recip(s + vz.z) * -1.0f;
  const float b = (vz.x * vz.y) * a;
  *vx = normalize(V3{((s * vz.x) * vz.x) * a + 1.0f, s * b, -s * vz.x});
  *vy = normalize(V3{b, s + (vz.y * vz.y) * a, -vz.y});
}

// ops/sampling.py scatter_dir
__device__ __forceinline__ V3 scatter_dir(V3 prev, float cos_theta, float phi) {
  prev = normalize(prev);
  const float sin_theta = fsqrt(tclamp_min(1.0f - cos_theta * cos_theta, 0.0f));
  const V3 local = normalize(V3{sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta});
  V3 vx, vy;
  local_frame(prev, &vx, &vy);
  return normalize(V3{(local.x * vx.x + local.y * vy.x) + local.z * prev.x,
                      (local.x * vx.y + local.y * vy.y) + local.z * prev.y,
                      (local.x * vx.z + local.y * vy.z) + local.z * prev.z});
}

// accel.py offset_ray, a component: p's bits moved by 256 n as an integer,
// or p + n / 65536 near 0
__device__ __forceinline__ float offset1(float p, float n) {
  const int of_i = static_cast<int>(256.0f * n);
  const uint32_t step = static_cast<uint32_t>(p < 0.0f ? -of_i : of_i);
  const float p_i = __uint_as_float(__float_as_uint(p) + step);
  return fabsf(p) < 0.03125f ? p + 1.52587890625e-05f * n : p_i;
}
__device__ __forceinline__ V3 offset_ray(V3 p, V3 n) { return V3{offset1(p.x, n.x), offset1(p.y, n.y), offset1(p.z, n.z)}; }

// RayState.contrib: lin * exp(log) in log space, clamped to [-87, 87]
__device__ __forceinline__ float contrib(float lin, float log) {
  const float mag = fabsf(lin);
  const float mag_safe = mag > 0.0f ? mag : 1.0f;
  const float log_total = tclamp(logf(mag_safe) + log, -87.0f, 87.0f);
  const float value = tsign(lin) * expf(log_total);
  return mag > 0.0f ? value : 0.0f;
}

// one packed read of K tables at a lane's medium
__device__ __forceinline__ float read1(const TheiaTableSpec& s, int medium, float x) {
  float v[theia_read::kMaxTables];
  theia_read::read_lane(s, medium, x, v);
  return v[0];
}

// ---- the tracer's helpers ----

// trace/core.py _effective_sample_coef: a negative or NaN scatter
// coefficient takes the medium's mu_s
__device__ __forceinline__ float sample_coef(const Const& c, float mu_s) {
  const float coef = __ldg(c.scatter_coef);
  return !(coef >= 0.0f) ? mu_s : coef;
}

// target.py SphereTargetGuide._cone at an observer
struct Cone {
  V3 view;
  float cos_min, prob, dist;
};

__device__ __forceinline__ Cone guide_cone(const Const& c, V3 observer) {
  const V3 center = row3(c.guide_position);
  const float radius = __ldg(c.guide_radius);
  const float d = norm(sub(center, observer));
  Cone k;
  k.view = normalize(sub(center, observer));
  const float sin_max = fdiv(radius, d);
  const float sin2 = sin_max * sin_max;
  k.cos_min = 1.0f - sqrt_positive(1.0f - sin2);
  k.cos_min = sin2 < 0.00068523f ? 0.5f * sin2 : k.cos_min;
  k.prob = recip(kTwoPi * k.cos_min);
  k.prob = k.prob * (d > radius ? 1.0f : 0.0f);
  k.dist = d + radius;
  return k;
}

// SphereTargetGuide.eval's pdf of a direction
__device__ __forceinline__ float guide_eval(const Cone& k, V3 direction) {
  const float cos_dir = dot(k.view, direction);
  return k.prob * (k.cos_min >= 1.0f - cos_dir ? 1.0f : 0.0f);
}

// SphereTargetGuide.sample's direction from its two draws
__device__ __forceinline__ V3 guide_direction(const Cone& k, float u1, float u2) {
  const float cos_theta = 1.0f - k.cos_min * u1;
  const float sin_theta = sqrt_positive(1.0f - cos_theta * cos_theta);
  const float phi = kTwoPi * u2;
  V3 vx, vy;
  local_frame(k.view, &vx, &vy);
  const float a = sin_theta * sinf(phi), b = sin_theta * cosf(phi);
  return V3{(a * vx.x + b * vy.x) + cos_theta * k.view.x, (a * vx.y + b * vy.y) + cos_theta * k.view.y,
            (a * vx.z + b * vy.z) + cos_theta * k.view.z};
}

// _scatter_prob_packed's log p of a direction pair
__device__ __forceinline__ float log_phase(const Const& c, int medium, V3 in_dir, V3 out_dir) {
  return read1(c.log_phase, medium, dot(in_dir, out_dir));
}

// _sample_phase_packed: (direction, pdf, log_p) from its two draws
struct PhaseSample {
  V3 dir;
  float pdf, log_p;
};

__device__ __forceinline__ PhaseSample phase_sample(const Const& c, int medium, V3 in_dir, float u1, float u2) {
  const float phi = kTwoPi * u1;
  const float cos_tab = read1(c.sampling, medium, u2);
  const bool has_tab = __ldg(c.sampling_sizes + medium) > 0;
  const float cos_theta = has_tab ? tclamp(cos_tab, -1.0f, 1.0f) : 2.0f * u2 - 1.0f;
  PhaseSample s;
  s.dir = scatter_dir(in_dir, cos_theta, phi);
  s.log_p = log_phase(c, medium, in_dir, s.dir);
  s.pdf = has_tab ? expf(s.log_p) : kInv4Pi;
  return s;
}

// accel.py _reconstruct_hit for one lane's winner (tri, -1 on a miss)
struct Hit {
  bool valid, inward;
  float t;
  int custom_id, flags, medium_tr, error;
  V3 world_pos, ray_nrm;
};

__device__ Hit reconstruct(const Const& c, int medium, V3 o, V3 d, float t_sel, int tri) {
  Hit h;
  h.valid = tri >= 0;
  const float* row = c.tri_data + 32ll * (tri > 0 ? tri : 0);
  const V3 o_v0 = row3(row), o_e1 = row3(row + 3), o_e2 = row3(row + 6);
  const V3 n0 = row3(row + 9), n1 = row3(row + 12), n2 = row3(row + 15);
  const V3 v0 = row3(row + 18), e1 = row3(row + 21), e2 = row3(row + 24);
  const int inst = static_cast<int>(__ldg(row + 27));
  // ops/math3d.py moeller_trumbore_rowwise
  const float px = d.y * e2.z - d.z * e2.y;
  const float py = d.z * e2.x - d.x * e2.z;
  const float pz = d.x * e2.y - d.y * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const float inv = fabsf(det) > 1e-12f ? recip(det) : 0.0f;
  const float tx = o.x - v0.x, ty = o.y - v0.y, tz = o.z - v0.z;
  const float b1 = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float b2 = (d.x * qx + d.y * qy + d.z * qz) * inv;
  const float t_win = (e2.x * qx + e2.y * qy + e2.z * qz) * inv;
  h.t = h.valid ? (inv != 0.0f ? t_win : t_sel) : __int_as_float(0x7F800000);

  const V3 obj_pos{(o_v0.x + b1 * o_e1.x) + b2 * o_e2.x, (o_v0.y + b1 * o_e1.y) + b2 * o_e2.y,
                   (o_v0.z + b1 * o_e1.z) + b2 * o_e2.z};
  V3 obj_nrm = cross(o_e1, o_e2);
  const V3 int_nrm{(n0.x + b1 * (n1.x - n0.x)) + b2 * (n2.x - n0.x), (n0.y + b1 * (n1.y - n0.y)) + b2 * (n2.y - n0.y),
                   (n0.z + b1 * (n1.z - n0.z)) + b2 * (n2.z - n0.z)};
  obj_nrm = normalize(scale(sign_bit(dot(obj_nrm, int_nrm)), obj_nrm));

  const float* irow = c.inst_data + 32ll * inst;
  float w2o[12], o2w[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    w2o[k] = __ldg(irow + k);
    o2w[k] = __ldg(irow + 12 + k);
  }
  const int inside = static_cast<int>(__ldg(irow + 24)), outside = static_cast<int>(__ldg(irow + 25));
  const int flags_in = static_cast<int>(__ldg(irow + 26)), flags_out = static_cast<int>(__ldg(irow + 27));
  h.custom_id = static_cast<int>(__ldg(irow + 28));
  const V3 obj_dir = normalize(V3{dot(V3{w2o[0], w2o[1], w2o[2]}, d), dot(V3{w2o[4], w2o[5], w2o[6]}, d),
                                  dot(V3{w2o[8], w2o[9], w2o[10]}, d)});
  h.inward = dot(obj_dir, obj_nrm) <= 0.0f;
  h.flags = h.inward ? flags_in : flags_out;
  const int expected = h.inward ? outside : inside;
  h.medium_tr = h.inward ? inside : outside;
  h.error = h.valid && medium != expected ? kMediaMismatch : 0;
  // world normal: the object normal times the linear world_to_obj, column by column
  const V3 world_nrm = normalize(V3{dot(obj_nrm, V3{w2o[0], w2o[4], w2o[8]}), dot(obj_nrm, V3{w2o[1], w2o[5], w2o[9]}),
                                    dot(obj_nrm, V3{w2o[2], w2o[6], w2o[10]})});
  h.ray_nrm = scale(h.inward ? 1.0f : -1.0f, world_nrm);
  h.world_pos = V3{dot(V3{o2w[0], o2w[1], o2w[2]}, obj_pos) + o2w[3], dot(V3{o2w[4], o2w[5], o2w[6]}, obj_pos) + o2w[7],
                   dot(V3{o2w[8], o2w[9], o2w[10]}, obj_pos) + o2w[11]};
  return h;
}

// _fresnel: (n_t, r_s, r_p) of the lane's hit, n_i the lane's n
struct Fresnel {
  float n_t, r_s, r_p;
};

__device__ __forceinline__ Fresnel fresnel(const Const& c, V3 direction, float n_i, float wavelength, const Hit& h) {
  float cos_i = tclamp(dot(direction, h.ray_nrm), -1.0f, 1.0f);
  const float sin_i = fsqrt(tclamp_min(1.0f - cos_i * cos_i, 0.0f));
  Fresnel f;
  f.n_t = read1(c.ior, h.medium_tr, wavelength);
  const float sin_t = fdiv(sin_i * n_i, f.n_t);
  const float s2 = 1.0f - sin_t * sin_t;
  const bool tir = s2 <= 0.0f;
  const float cos_t = tir ? 0.0f : fsqrt(tir ? 1.0f : s2);
  cos_i = fabsf(cos_i);
  f.r_s = fdiv(n_i * cos_i - f.n_t * cos_t, n_i * cos_i + f.n_t * cos_t);
  f.r_p = fdiv(f.n_t * cos_i - n_i * cos_t, f.n_t * cos_i + n_i * cos_t);
  return f;
}

// _create_response_item's value: the contribution, the transmission
// emulated where the surface is not black
__device__ __forceinline__ float item_value(float lin, float log, const Fresnel& f, bool absorb) {
  const float transmittance = 1.0f - 0.5f * (f.r_s * f.r_s + f.r_p * f.r_p);
  return contrib(absorb ? lin : lin * transmittance, log);
}

// _propagate_to_hit: the time and log after the distance to the hit,
// reattach_geometry's zero term included; returns update_ray's code
__device__ __forceinline__ int to_hit(const Const& c, V3 position, V3 world_pos, float vg, float mu_e, float* time,
                                      float* log) {
  const V3 delta = sub(world_pos, position);
  const float dist = fsqrt(tclamp_min(dot(delta, delta), 1e-30f));
  *log = *log - mu_e * dist;
  *time = *time + fdiv(dist, vg);
  const int code = *time <= __ldg(c.max_time) ? kSuccess : kDecayed;
  const float dt = dist - dist;
  *time = *time + fdiv(dt, vg);
  *log = *log - mu_e * dt;
  return code;
}

// ---- the kernels ----

__device__ __forceinline__ PhiloxBase philox_base(const Const& c) {
  return PhiloxBase{c.key[0], c.key[1], c.counter[0], c.counter[1], c.counter[2], c.counter[3]};
}

__global__ void __launch_bounds__(kThreads) segment_pre(Const c, Lanes l) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= l.count) return;
  const V3 position = load3(l.position, i), direction = load3(l.direction, i);
  const float mu_s = l.mu_s[i];
  const bool bad = !finite3(position) || !finite3(direction) || dot(direction, direction) <= 0.0f;
  l.pre_alive[i] = l.alive[i] && !bad;
  PhiloxLane rng(philox_base(c), static_cast<uint32_t>(l.stream[i]), static_cast<uint32_t>(l.dim[i]));
  const float uu = rng.uniform();
  // sample_scatter_length
  const float coef = sample_coef(c, mu_s);
  const bool sample = coef != 0.0f && mu_s > 0.0f;
  const float safe = sample ? coef : 1.0f;
  float dist = fdiv(-log1pf(-uu), safe);
  dist = sample ? dist : __ldg(c.max_dist);
  l.sampled[i] = dist;
  // the guide's eval along the ray: a hit beyond the sampled distance is a
  // free shadow ray
  const Cone k = guide_cone(c, position);
  const float prob = guide_eval(k, direction);
  const bool ext = l.allow[i] && prob > 0.0f && k.dist > dist;
  l.mis_ext[i] = ext;
  l.t_max[i] = ext ? tmax(k.dist, dist) : dist;
  l.pre_dim[i] = static_cast<int>(rng.dim);
}

__global__ void __launch_bounds__(kThreads) segment_surface(Const c, Lanes l) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= l.count) return;
  const V3 position = load3(l.position, i), direction = load3(l.direction, i);
  const float wavelength = l.wavelength[i], n_i = l.n[i], vg = l.vg[i], mu_s = l.mu_s[i], mu_e = l.mu_e[i];
  const int medium = l.medium[i];
  const bool pre_alive = l.pre_alive[i];
  const float sampled = l.sampled[i];
  const int target_id = __ldg(c.target_id);

  Hit h = reconstruct(c, medium, position, direction, l.t_hit[i], l.tri[i]);
  float travel = h.valid ? h.t : l.t_max[i];
  const bool ext_mask = pre_alive && l.mis_ext[i] && h.valid && travel > sampled && h.error == 0;
  // the extension's ray, propagated to its hit
  float ext_time = l.time[i], ext_log = l.log[i];
  const int ext_code = to_hit(c, position, h.world_pos, vg, mu_e, &ext_time, &ext_log);
  const bool ext_ok = ext_mask && ext_code >= 0;
  h.valid = h.valid && !ext_mask;
  travel = ext_mask ? sampled : travel;

  // propagate_ray
  V3 pos{position.x + travel * direction.x, position.y + travel * direction.y, position.z + travel * direction.z};
  const V3 lo = row3(c.lower), hi = row3(c.upper);
  const bool outside = pos.x < lo.x || pos.x > hi.x || pos.y < lo.y || pos.y > hi.y || pos.z < lo.z || pos.z > hi.z;
  float log = l.log[i] - mu_e * travel;
  float time = l.time[i] + fdiv(travel, vg);
  int code = time <= __ldg(c.max_time) ? kSuccess : kDecayed;
  code = outside ? kLost : code;
  // reattach_geometry's zero term, on the hit lanes
  float dt = travel - travel;
  dt = h.valid ? dt : 0.0f;
  time = time + fdiv(dt, vg);
  log = log - mu_e * dt;
  // update_ray_is
  const float coef = sample_coef(c, mu_s);
  const bool can_scatter = mu_s > 0.0f;
  const float log_is = can_scatter ? coef * travel : 0.0f;
  const float inv = recip(coef > 0.0f ? coef : 1.0f);
  const float lin_is = can_scatter && !h.valid ? inv : 1.0f;
  log = log + log_is;
  const float lin = l.lin[i] * lin_is;
  code = h.valid && h.error != 0 ? h.error : code;
  const bool in_bounds = code >= 0;

  // the surface
  const bool surf = pre_alive && in_bounds && h.valid;
  pos = pick(surf, h.world_pos, pos);
  const Fresnel f = fresnel(c, direction, n_i, wavelength, h);
  const bool is_abs = (h.flags & kBlack) != 0;
  const bool is_target = (h.flags & kDetector) != 0;
  const bool vol_border = c.volume_border && (h.flags & kVolume) != 0;
  const bool can_reflect = (h.flags & kNoReflect) == 0;
  const bool can_transmit = c.transmission && (h.flags & kNoTransmit) == 0;
  const bool correct = target_id < 0 || h.custom_id == target_id;
  const bool respond = surf && l.allow[i] && is_target && correct;
  // the fused record: the extension's lanes respond with their ray at the hit
  const bool rec = respond || (ext_ok && is_target && correct);
  const float value = item_value(ext_ok ? l.lin[i] : lin, ext_ok ? ext_log : log, f, is_abs);
  l.value[i] = value;
  l.item_time[i] = ext_ok ? ext_time : time;
  l.mask[i] = rec && value > 0.0f;
  if (l.object_id != nullptr) l.object_id[i] = h.custom_id;

  // the surface's outcome
  const float r_coef = 0.5f * (f.r_s * f.r_s + f.r_p * f.r_p);
  const uint32_t dim = static_cast<uint32_t>(l.pre_dim[i]);
  PhiloxLane rng(philox_base(c), static_cast<uint32_t>(l.stream[i]), dim);
  const float u_surf = rng.uniform();
  const bool both = surf && !is_abs && !vol_border && can_reflect && can_transmit;
  rng.merged(dim, both);
  const bool do_reflect = both ? u_surf < r_coef : can_reflect;
  const bool absorbed_surf = surf && (is_abs || (!can_reflect && !can_transmit && !vol_border));

  const V3 refl_dir = normalize(sub(direction, scale(2.0f * dot(h.ray_nrm, direction), h.ray_nrm)));
  const V3 refl_pos = offset_ray(h.world_pos, h.ray_nrm);
  const float refl_factor = both ? 1.0f : r_coef;
  const float refl_log = both ? logf(tclamp_min(r_coef, 1e-30f)) : 0.0f;
  const float refl_corr = refl_log - refl_log;
  const float eta = fdiv(n_i, f.n_t);
  // _refract (GLSL refract), the inverted normal on total internal reflection
  const float cos_r = dot(h.ray_nrm, direction);
  const float k = 1.0f - (eta * eta) * (1.0f - cos_r * cos_r);
  const bool tir = k <= 0.0f;
  const float mu = eta * cos_r + fsqrt(tir ? 1.0f : k);
  const V3 refracted{eta * direction.x - mu * h.ray_nrm.x, eta * direction.y - mu * h.ray_nrm.y,
                     eta * direction.z - mu * h.ray_nrm.z};
  const V3 trans_dir = normalize(tir ? neg(h.ray_nrm) : refracted);
  const V3 trans_pos = offset_ray(h.world_pos, neg(h.ray_nrm));
  const float trans_factor = both ? 1.0f : 1.0f - r_coef;
  const float trans_log = both ? logf(tclamp_min(1.0f - r_coef, 1e-30f)) : 0.0f;
  const float trans_corr = trans_log - trans_log;

  const int new_medium =
      surf && (vol_border || (!do_reflect && can_transmit && !is_abs)) ? h.medium_tr : medium;
  const bool crossed = new_medium != medium;
  const bool sel_reflect = surf && !is_abs && !vol_border && do_reflect && can_reflect;
  const bool sel_transmit = surf && !is_abs && !vol_border && !do_reflect && can_transmit;
  store3(l.out_direction, i, sel_reflect ? refl_dir : (sel_transmit ? trans_dir : direction));
  store3(l.out_position, i,
         sel_reflect ? refl_pos : ((sel_transmit || (surf && vol_border)) ? trans_pos : pos));
  l.out_lin[i] = sel_reflect ? lin * refl_factor : (sel_transmit ? lin * trans_factor : lin);
  l.out_log[i] = sel_reflect ? log + refl_corr : (sel_transmit ? log + trans_corr : log);
  l.out_time[i] = time;
  // packed_medium_constants at the new medium: mu_e = mu_a + mu_s
  float k4[theia_read::kMaxTables];
  theia_read::read_lane(c.constants, new_medium, wavelength, k4);
  l.out_n[i] = crossed ? k4[2] : n_i;
  l.out_vg[i] = crossed ? k4[3] : vg;
  l.out_mu_s[i] = crossed ? k4[1] : mu_s;
  l.out_mu_e[i] = crossed ? k4[0] + k4[1] : mu_e;
  l.out_medium[i] = new_medium;

  // the result codes (none depends on the scatter)
  code = surf && respond ? kDetected
                         : (surf && vol_border ? kVolumeHit : (surf ? kHit : (pre_alive && in_bounds ? kScattered : code)));
  code = absorbed_surf ? kAbsorbed : code;
  l.out_alive[i] = pre_alive && code >= 0 && !absorbed_surf;
  l.out_allow[i] = code != kScattered;
  l.miss[i] = pre_alive && in_bounds && !h.valid;
  l.out_dim[i] = static_cast<int>(rng.dim);
}

__global__ void __launch_bounds__(kThreads) segment_scatter(Const c, Lanes l) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int n = l.count;
  if (i >= n) return;
  const V3 position = load3(l.position, i), direction = load3(l.direction, i);
  const float lin = l.lin[i], log = l.log[i], mu_s = l.mu_s[i];
  const int medium = l.medium[i];
  const bool miss = l.miss[i];
  const uint32_t dim = static_cast<uint32_t>(l.dim[i]);
  PhiloxLane rng(philox_base(c), static_cast<uint32_t>(l.stream[i]), dim);

  // _mis_shadow: the phase sample, the guide sample, their weights
  const float u1 = rng.uniform(), u2 = rng.uniform();
  const PhaseSample ph = phase_sample(c, medium, direction, u1, u2);
  const Cone k = guide_cone(c, position);
  const float g1 = rng.uniform(), g2 = rng.uniform();
  const V3 guide_dir = guide_direction(k, g1, g2);
  const float p_tt = k.prob;
  const float p_tp = guide_eval(k, ph.dir);
  const float log_p_pt = log_phase(c, medium, direction, guide_dir);
  const float p_pt = expf(log_p_pt);
  const float w_target = finite_or_zero(fdiv(p_tt * p_pt, p_tt * p_tt + p_pt * p_pt));
  const float w_phase = finite_or_zero(fdiv(ph.pdf * ph.pdf, ph.pdf * ph.pdf + p_tp * p_tp));
  const int j = n + i;
  store3(l.shadow_origin, i, position);
  store3(l.shadow_origin, j, position);
  store3(l.shadow_direction, i, ph.dir);
  store3(l.shadow_direction, j, guide_dir);
  l.shadow_t_max[i] = k.dist;
  l.shadow_t_max[j] = k.dist;
  l.shadow_lin[i] = (lin * mu_s) * w_phase;
  l.shadow_lin[j] = (lin * mu_s) * w_target;
  l.shadow_log[i] = (log + ph.log_p) - ph.log_p;
  l.shadow_log[j] = (log + log_p_pt) - log_p_pt;
  l.shadow_medium[i] = medium;
  l.shadow_medium[j] = medium;
  l.shadow_active[i] = miss;
  l.shadow_active[j] = miss;
  rng.merged(dim, miss);

  // the real ray's phase scatter
  const uint32_t dim2 = rng.dim;
  const float s1 = rng.uniform(), s2 = rng.uniform();
  const PhaseSample sc = phase_sample(c, medium, direction, s1, s2);
  const float corr = sc.log_p - sc.log_p;
  store3(l.out_direction, i, miss ? sc.dir : direction);
  l.out_lin[i] = miss ? lin * mu_s : lin;
  l.out_log[i] = miss ? log + corr : log;
  rng.merged(dim2, miss);
  l.out_dim[i] = static_cast<int>(rng.dim);
}

__global__ void __launch_bounds__(kThreads) segment_shadow(Const c, Lanes l) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= l.count) return;
  const int half = l.count / 2;
  const int i = j < half ? j : j - half;
  const V3 origin = load3(l.shadow_origin, j), direction = load3(l.shadow_direction, j);
  const int medium = l.shadow_medium[j];
  const Hit h = reconstruct(c, medium, origin, direction, l.t_hit[j], l.tri[j]);
  // _shadow_item
  const int target_id = __ldg(c.target_id);
  const bool is_target = (h.flags & kDetector) != 0;
  const bool correct = target_id < 0 || h.custom_id == target_id;
  bool ok = l.shadow_active[j] && h.valid && is_target && correct && h.error == 0;
  float time = l.time[i], log = l.shadow_log[j];
  const int code = to_hit(c, origin, h.world_pos, l.vg[i], l.mu_e[i], &time, &log);
  ok = ok && code >= 0;
  const Fresnel f = fresnel(c, direction, l.n[i], l.wavelength[i], h);
  const float value = item_value(l.shadow_lin[j], log, f, (h.flags & kBlack) != 0);
  l.value[j] = value;
  l.item_time[j] = time;
  l.mask[j] = ok && value > 0.0f;
  if (l.object_id != nullptr) l.object_id[j] = h.custom_id;
}

template <class Kernel>
int launch(Kernel kernel, const Const* c, const Lanes* l, cudaStream_t stream) {
  if (c == nullptr || l == nullptr || l->count < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (l->count > 0) kernel<<<(l->count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(*c, *l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int theia_segment_pre(const TheiaSegmentConst* c, const TheiaSegmentLanes* l, cudaStream_t stream) {
  return launch(segment_pre, c, l, stream);
}

extern "C" int theia_segment_surface(const TheiaSegmentConst* c, const TheiaSegmentLanes* l, cudaStream_t stream) {
  return launch(segment_surface, c, l, stream);
}

extern "C" int theia_segment_scatter(const TheiaSegmentConst* c, const TheiaSegmentLanes* l, cudaStream_t stream) {
  return launch(segment_scatter, c, l, stream);
}

// count: the 2N shadow rays
extern "C" int theia_segment_shadow(const TheiaSegmentConst* c, const TheiaSegmentLanes* l, cudaStream_t stream) {
  if (l != nullptr && l->count % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(segment_shadow, c, l, stream);
}
