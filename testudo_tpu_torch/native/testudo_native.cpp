// Native host library of the PyTorch/CUDA port (a copy of testudo_tpu/native/testudo_native.cpp): BLS12-377 field towers,
// curve arithmetic, Pippenger MSM, and the optimal ate pairing.
//
// This is the C++ runtime counterpart of the Python host reference
// (testudo_tpu_torch/fields/host.py, curves/host_curve.py, curves/pairing.py):
// identical tower layout (Fq2 = Fq[u]/(u^2+5), Fq6 = Fq2[v]/(v^3-u),
// Fq12 = Fq6[w]/(w^2-v)) and a final exponentiation evaluated with the same
// base-p digit decomposition, so every exported value is bit-identical to
// the Python implementation.  It accelerates the host-side hot paths that
// are latency-bound rather than throughput-bound (multi-pairings in sqrt-PST
// commit / MIPP, GT exponentiations in MIPP verify, SRS setup powers);
// throughput-bound MSMs stay on the GPU (testudo_tpu_torch/device/msm.py).
//
// Reference parity: replaces the asm/blst native layers the reference pulls
// in through ark-ff/ark-blst (reference Cargo.toml:24-26, 74-82).
//
// ABI: little-endian canonical byte buffers (48B Fq, 32B scalar, 96B G1
// affine, 192B G2 affine, 576B Fq12); the point at infinity is all-zero.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "constants_377.h"

namespace tn {

typedef unsigned __int128 u128;

// ---------------------------------------------------------------------------
// Fq: 6x64-bit Montgomery arithmetic
// ---------------------------------------------------------------------------

struct Fq {
  uint64_t v[6];
};

static inline bool fq_is_zero(const Fq &a) {
  uint64_t r = 0;
  for (int i = 0; i < 6; i++) r |= a.v[i];
  return r == 0;
}

static inline bool fq_eq(const Fq &a, const Fq &b) {
  uint64_t r = 0;
  for (int i = 0; i < 6; i++) r |= a.v[i] ^ b.v[i];
  return r == 0;
}

static inline bool fq_gte_p(const Fq &a) {
  for (int i = 5; i >= 0; i--) {
    if (a.v[i] > FQ_P[i]) return true;
    if (a.v[i] < FQ_P[i]) return false;
  }
  return true;  // equal
}

static inline void fq_reduce_once(Fq &a) {
  if (fq_gte_p(a)) {
    u128 borrow = 0;
    for (int i = 0; i < 6; i++) {
      u128 cur = (u128)a.v[i] - FQ_P[i] - (uint64_t)borrow;
      a.v[i] = (uint64_t)cur;
      borrow = (cur >> 64) & 1;  // 1 if borrowed
    }
  }
}

static inline void fq_add(Fq &r, const Fq &a, const Fq &b) {
  u128 carry = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)a.v[i] + b.v[i] + (uint64_t)carry;
    r.v[i] = (uint64_t)cur;
    carry = cur >> 64;
  }
  // p < 2^378 so a+b < 2^379: no limb overflow past 6 limbs
  fq_reduce_once(r);
}

static inline void fq_sub(Fq &r, const Fq &a, const Fq &b) {
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)a.v[i] - b.v[i] - (uint64_t)borrow;
    r.v[i] = (uint64_t)cur;
    borrow = (cur >> 64) & 1;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 6; i++) {
      u128 cur = (u128)r.v[i] + FQ_P[i] + (uint64_t)carry;
      r.v[i] = (uint64_t)cur;
      carry = cur >> 64;
    }
  }
}

static inline void fq_neg(Fq &r, const Fq &a) {
  if (fq_is_zero(a)) {
    r = a;
    return;
  }
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)FQ_P[i] - a.v[i] - (uint64_t)borrow;
    r.v[i] = (uint64_t)cur;
    borrow = (cur >> 64) & 1;
  }
}

static inline void fq_dbl(Fq &r, const Fq &a) { fq_add(r, a, a); }

// CIOS Montgomery multiplication (p fits with slack in 6 limbs: p < 2^377,
// so the running accumulator never overflows 7 limbs and the final value
// is < 2p).
static void fq_mul(Fq &r, const Fq &a, const Fq &b) {
  uint64_t t[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 6; i++) {
    u128 carry = 0;
    uint64_t bi = b.v[i];
    for (int j = 0; j < 6; j++) {
      u128 cur = (u128)a.v[j] * bi + t[j] + (uint64_t)carry;
      t[j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[6] + (uint64_t)carry;
    uint64_t t7 = (uint64_t)(cur >> 64);
    t[6] = (uint64_t)cur;

    uint64_t m = t[0] * FQ_PINV;
    carry = ((u128)m * FQ_P[0] + t[0]) >> 64;
    for (int j = 1; j < 6; j++) {
      u128 cur2 = (u128)m * FQ_P[j] + t[j] + (uint64_t)carry;
      t[j - 1] = (uint64_t)cur2;
      carry = cur2 >> 64;
    }
    cur = (u128)t[6] + (uint64_t)carry;
    t[5] = (uint64_t)cur;
    t[6] = t7 + (uint64_t)(cur >> 64);
  }
  for (int i = 0; i < 6; i++) r.v[i] = t[i];
  fq_reduce_once(r);
}

static inline void fq_sqr(Fq &r, const Fq &a) { fq_mul(r, a, a); }

static const Fq FQ_ZERO = {{0, 0, 0, 0, 0, 0}};

static Fq FQ_ONE;   // Montgomery one (R mod p), set in init
static Fq FQ_R2M;   // R^2 mod p
static Fq QNR_M;    // -5 in Montgomery form

static void fq_from_canon(Fq &r, const uint64_t limbs[6]) {
  Fq t;
  for (int i = 0; i < 6; i++) t.v[i] = limbs[i];
  fq_mul(r, t, FQ_R2M);  // to Montgomery form
}

static void fq_to_canon(uint64_t out[6], const Fq &a) {
  // Montgomery reduce by multiplying with 1
  Fq one_raw = {{1, 0, 0, 0, 0, 0}};
  Fq t;
  fq_mul(t, a, one_raw);
  for (int i = 0; i < 6; i++) out[i] = t.v[i];
}

// pow by canonical (non-Montgomery) exponent limbs, MSB-first scan
static void fq_pow_limbs(Fq &r, const Fq &a, const uint64_t *e, int nlimbs) {
  Fq res = FQ_ONE;
  bool started = false;
  for (int li = nlimbs - 1; li >= 0; li--) {
    for (int bi = 63; bi >= 0; bi--) {
      if (started) fq_sqr(res, res);
      if ((e[li] >> bi) & 1) {
        if (started) {
          fq_mul(res, res, a);
        } else {
          res = a;
          started = true;
        }
      }
    }
  }
  r = res;
}

static void fq_inv(Fq &r, const Fq &a) {
  // Fermat: a^(p-2)
  uint64_t e[6];
  u128 borrow = 0;
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)FQ_P[i] - (i == 0 ? 2 : 0) - (uint64_t)borrow;
    e[i] = (uint64_t)cur;
    borrow = (cur >> 64) & 1;
  }
  fq_pow_limbs(r, a, e, 6);
}

// multiply by the quadratic nonresidue -5 (tower constant)
static inline void fq_mul_qnr(Fq &r, const Fq &a) {
  Fq a2, a4;
  fq_dbl(a2, a);
  fq_dbl(a4, a2);
  fq_add(a4, a4, a);  // 5a
  fq_neg(r, a4);
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u] / (u^2 + 5)
// ---------------------------------------------------------------------------

struct Fq2 {
  Fq c0, c1;
};

static inline bool fq2_is_zero(const Fq2 &a) {
  return fq_is_zero(a.c0) && fq_is_zero(a.c1);
}
static inline bool fq2_eq(const Fq2 &a, const Fq2 &b) {
  return fq_eq(a.c0, b.c0) && fq_eq(a.c1, b.c1);
}
static inline void fq2_add(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fq_add(r.c0, a.c0, b.c0);
  fq_add(r.c1, a.c1, b.c1);
}
static inline void fq2_sub(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fq_sub(r.c0, a.c0, b.c0);
  fq_sub(r.c1, a.c1, b.c1);
}
static inline void fq2_neg(Fq2 &r, const Fq2 &a) {
  fq_neg(r.c0, a.c0);
  fq_neg(r.c1, a.c1);
}
static inline void fq2_dbl(Fq2 &r, const Fq2 &a) { fq2_add(r, a, a); }

static void fq2_mul(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  Fq t0, t1, s0, s1, t2;
  fq_mul(t0, a.c0, b.c0);
  fq_mul(t1, a.c1, b.c1);
  fq_add(s0, a.c0, a.c1);
  fq_add(s1, b.c0, b.c1);
  fq_mul(t2, s0, s1);
  fq_sub(t2, t2, t0);
  fq_sub(t2, t2, t1);  // cross term
  Fq q;
  fq_mul_qnr(q, t1);
  fq_add(r.c0, t0, q);
  r.c1 = t2;
}

static void fq2_sqr(Fq2 &r, const Fq2 &a) {
  Fq t0, t1, cross;
  fq_sqr(t0, a.c0);
  fq_sqr(t1, a.c1);
  fq_mul(cross, a.c0, a.c1);
  fq_dbl(cross, cross);
  Fq q;
  fq_mul_qnr(q, t1);
  fq_add(r.c0, t0, q);
  r.c1 = cross;
}

static inline void fq2_mul_fq(Fq2 &r, const Fq2 &a, const Fq &s) {
  fq_mul(r.c0, a.c0, s);
  fq_mul(r.c1, a.c1, s);
}

static void fq2_inv(Fq2 &r, const Fq2 &a) {
  Fq n0, n1, norm, ninv;
  fq_sqr(n0, a.c0);
  fq_sqr(n1, a.c1);
  Fq q;
  fq_mul_qnr(q, n1);
  fq_sub(norm, n0, q);
  fq_inv(ninv, norm);
  fq_mul(r.c0, a.c0, ninv);
  Fq t;
  fq_mul(t, a.c1, ninv);
  fq_neg(r.c1, t);
}

static inline void fq2_conj(Fq2 &r, const Fq2 &a) {
  r.c0 = a.c0;
  fq_neg(r.c1, a.c1);
}

// multiply by XI = u (the Fq6 cubic nonresidue): (c0 + c1 u) u = -5 c1 + c0 u
static inline void fq2_mul_nonresidue(Fq2 &r, const Fq2 &a) {
  Fq t;
  fq_mul_qnr(t, a.c1);
  r.c1 = a.c0;
  r.c0 = t;
}

static Fq2 FQ2_ZERO, FQ2_ONE;
static Fq2 FROB6C1_M[6], FROB6C2_M[6], FROB12C1_M[12];

static inline void fq2_frobenius(Fq2 &r, const Fq2 &a, int power) {
  if (power % 2 == 0)
    r = a;
  else
    fq2_conj(r, a);
}

// ---------------------------------------------------------------------------
// Fq6 = Fq2[v] / (v^3 - u)
// ---------------------------------------------------------------------------

struct Fq6 {
  Fq2 c0, c1, c2;
};

static inline void fq6_add(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  fq2_add(r.c0, a.c0, b.c0);
  fq2_add(r.c1, a.c1, b.c1);
  fq2_add(r.c2, a.c2, b.c2);
}
static inline void fq6_sub(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  fq2_sub(r.c0, a.c0, b.c0);
  fq2_sub(r.c1, a.c1, b.c1);
  fq2_sub(r.c2, a.c2, b.c2);
}
static inline void fq6_neg(Fq6 &r, const Fq6 &a) {
  fq2_neg(r.c0, a.c0);
  fq2_neg(r.c1, a.c1);
  fq2_neg(r.c2, a.c2);
}

static void fq6_mul(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  Fq2 t0, t1, t2, s0, s1, tmp, c0, c1, c2;
  fq2_mul(t0, a.c0, b.c0);
  fq2_mul(t1, a.c1, b.c1);
  fq2_mul(t2, a.c2, b.c2);

  fq2_add(s0, a.c1, a.c2);
  fq2_add(s1, b.c1, b.c2);
  fq2_mul(tmp, s0, s1);
  fq2_sub(tmp, tmp, t1);
  fq2_sub(tmp, tmp, t2);
  fq2_mul_nonresidue(tmp, tmp);
  fq2_add(c0, tmp, t0);

  fq2_add(s0, a.c0, a.c1);
  fq2_add(s1, b.c0, b.c1);
  fq2_mul(tmp, s0, s1);
  fq2_sub(tmp, tmp, t0);
  fq2_sub(tmp, tmp, t1);
  Fq2 t2nr;
  fq2_mul_nonresidue(t2nr, t2);
  fq2_add(c1, tmp, t2nr);

  fq2_add(s0, a.c0, a.c2);
  fq2_add(s1, b.c0, b.c2);
  fq2_mul(tmp, s0, s1);
  fq2_sub(tmp, tmp, t0);
  fq2_sub(tmp, tmp, t2);
  fq2_add(c2, tmp, t1);

  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

static inline void fq6_sqr(Fq6 &r, const Fq6 &a) { fq6_mul(r, a, a); }

static inline void fq6_mul_fq2(Fq6 &r, const Fq6 &a, const Fq2 &s) {
  fq2_mul(r.c0, a.c0, s);
  fq2_mul(r.c1, a.c1, s);
  fq2_mul(r.c2, a.c2, s);
}

// multiply by v (for the Fq12 tower): (c0,c1,c2) -> (u*c2, c0, c1)
static inline void fq6_mul_nonresidue(Fq6 &r, const Fq6 &a) {
  Fq2 t;
  fq2_mul_nonresidue(t, a.c2);
  Fq2 old0 = a.c0, old1 = a.c1;
  r.c0 = t;
  r.c1 = old0;
  r.c2 = old1;
}

static void fq6_inv(Fq6 &r, const Fq6 &a) {
  Fq2 t0, t1, t2, tmp, acc, t;
  // t0 = c0^2 - u*(c1*c2)
  fq2_sqr(t0, a.c0);
  fq2_mul(tmp, a.c1, a.c2);
  fq2_mul_nonresidue(tmp, tmp);
  fq2_sub(t0, t0, tmp);
  // t1 = u*c2^2 - c0*c1
  fq2_sqr(t1, a.c2);
  fq2_mul_nonresidue(t1, t1);
  fq2_mul(tmp, a.c0, a.c1);
  fq2_sub(t1, t1, tmp);
  // t2 = c1^2 - c0*c2
  fq2_sqr(t2, a.c1);
  fq2_mul(tmp, a.c0, a.c2);
  fq2_sub(t2, t2, tmp);
  // t = inv(u*(c2*t1 + c1*t2) + c0*t0)
  fq2_mul(acc, a.c2, t1);
  fq2_mul(tmp, a.c1, t2);
  fq2_add(acc, acc, tmp);
  fq2_mul_nonresidue(acc, acc);
  fq2_mul(tmp, a.c0, t0);
  fq2_add(acc, acc, tmp);
  fq2_inv(t, acc);
  fq2_mul(r.c0, t0, t);
  fq2_mul(r.c1, t1, t);
  fq2_mul(r.c2, t2, t);
}

static void fq6_frobenius(Fq6 &r, const Fq6 &a, int power) {
  Fq2 c0, c1, c2;
  fq2_frobenius(c0, a.c0, power);
  fq2_frobenius(c1, a.c1, power);
  fq2_frobenius(c2, a.c2, power);
  fq2_mul(c1, c1, FROB6C1_M[power % 6]);
  fq2_mul(c2, c2, FROB6C2_M[power % 6]);
  r.c0 = c0;
  r.c1 = c1;
  r.c2 = c2;
}

static Fq6 FQ6_ZERO, FQ6_ONE;

// ---------------------------------------------------------------------------
// Fq12 = Fq6[w] / (w^2 - v)
// ---------------------------------------------------------------------------

struct Fq12 {
  Fq6 c0, c1;
};

static inline bool fq12_eq(const Fq12 &a, const Fq12 &b) {
  const uint64_t *pa = (const uint64_t *)&a, *pb = (const uint64_t *)&b;
  uint64_t r = 0;
  for (size_t i = 0; i < sizeof(Fq12) / 8; i++) r |= pa[i] ^ pb[i];
  return r == 0;
}

static void fq12_mul(Fq12 &r, const Fq12 &a, const Fq12 &b) {
  Fq6 t0, t1, s0, s1, c1;
  fq6_mul(t0, a.c0, b.c0);
  fq6_mul(t1, a.c1, b.c1);
  fq6_add(s0, a.c0, a.c1);
  fq6_add(s1, b.c0, b.c1);
  fq6_mul(c1, s0, s1);
  fq6_sub(c1, c1, t0);
  fq6_sub(c1, c1, t1);
  Fq6 t1nr;
  fq6_mul_nonresidue(t1nr, t1);
  fq6_add(r.c0, t0, t1nr);
  r.c1 = c1;
}

static void fq12_sqr(Fq12 &r, const Fq12 &a) {
  // complex squaring mirroring fields/host.py Fq12.square
  Fq6 t, s0, s1, c0;
  fq6_mul(t, a.c0, a.c1);
  fq6_add(s0, a.c0, a.c1);
  Fq6 a1nr;
  fq6_mul_nonresidue(a1nr, a.c1);
  fq6_add(s1, a.c0, a1nr);
  fq6_mul(c0, s0, s1);
  fq6_sub(c0, c0, t);
  Fq6 tnr;
  fq6_mul_nonresidue(tnr, t);
  fq6_sub(c0, c0, tnr);
  r.c0 = c0;
  fq6_add(r.c1, t, t);
}

static void fq12_inv(Fq12 &r, const Fq12 &a) {
  Fq6 t0, t1, t;
  fq6_sqr(t0, a.c0);
  fq6_sqr(t1, a.c1);
  fq6_mul_nonresidue(t1, t1);
  fq6_sub(t0, t0, t1);
  fq6_inv(t, t0);
  fq6_mul(r.c0, a.c0, t);
  Fq6 neg;
  fq6_mul(neg, a.c1, t);
  fq6_neg(r.c1, neg);
}

static inline void fq12_conj(Fq12 &r, const Fq12 &a) {
  r.c0 = a.c0;
  fq6_neg(r.c1, a.c1);
}

static void fq12_frobenius(Fq12 &r, const Fq12 &a, int power) {
  Fq6 c0, c1;
  fq6_frobenius(c0, a.c0, power);
  fq6_frobenius(c1, a.c1, power);
  const Fq2 &g = FROB12C1_M[power % 12];
  fq2_mul(c1.c0, c1.c0, g);
  fq2_mul(c1.c1, c1.c1, g);
  fq2_mul(c1.c2, c1.c2, g);
  r.c0 = c0;
  r.c1 = c1;
}

static Fq12 FQ12_ONE;

// pow by canonical exponent limbs (MSB-first)
static void fq12_pow_limbs(Fq12 &r, const Fq12 &a, const uint64_t *e,
                           int nlimbs) {
  Fq12 res = FQ12_ONE;
  bool started = false;
  for (int li = nlimbs - 1; li >= 0; li--) {
    for (int bi = 63; bi >= 0; bi--) {
      if (started) fq12_sqr(res, res);
      if ((e[li] >> bi) & 1) {
        if (started) {
          fq12_mul(res, res, a);
        } else {
          res = a;
          started = true;
        }
      }
    }
  }
  r = res;
}

// ---------------------------------------------------------------------------
// Curve points: affine + Jacobian, generic over the coordinate field
// ---------------------------------------------------------------------------

template <class F>
struct FOps;

template <>
struct FOps<Fq> {
  static void add(Fq &r, const Fq &a, const Fq &b) { fq_add(r, a, b); }
  static void sub(Fq &r, const Fq &a, const Fq &b) { fq_sub(r, a, b); }
  static void mul(Fq &r, const Fq &a, const Fq &b) { fq_mul(r, a, b); }
  static void sqr(Fq &r, const Fq &a) { fq_sqr(r, a); }
  static void neg(Fq &r, const Fq &a) { fq_neg(r, a); }
  static void dbl(Fq &r, const Fq &a) { fq_dbl(r, a); }
  static bool is_zero(const Fq &a) { return fq_is_zero(a); }
  static bool eq(const Fq &a, const Fq &b) { return fq_eq(a, b); }
  static void set_zero(Fq &a) { a = FQ_ZERO; }
  static void set_one(Fq &a) { a = FQ_ONE; }
  static void inv(Fq &r, const Fq &a) { fq_inv(r, a); }
};

template <>
struct FOps<Fq2> {
  static void add(Fq2 &r, const Fq2 &a, const Fq2 &b) { fq2_add(r, a, b); }
  static void sub(Fq2 &r, const Fq2 &a, const Fq2 &b) { fq2_sub(r, a, b); }
  static void mul(Fq2 &r, const Fq2 &a, const Fq2 &b) { fq2_mul(r, a, b); }
  static void sqr(Fq2 &r, const Fq2 &a) { fq2_sqr(r, a); }
  static void neg(Fq2 &r, const Fq2 &a) { fq2_neg(r, a); }
  static void dbl(Fq2 &r, const Fq2 &a) { fq2_dbl(r, a); }
  static bool is_zero(const Fq2 &a) { return fq2_is_zero(a); }
  static bool eq(const Fq2 &a, const Fq2 &b) { return fq2_eq(a, b); }
  static void set_zero(Fq2 &a) { a = FQ2_ZERO; }
  static void set_one(Fq2 &a) { a = FQ2_ONE; }
  static void inv(Fq2 &r, const Fq2 &a) { fq2_inv(r, a); }
};

template <class F>
struct Aff {
  F x, y;
  bool inf;
};

template <class F>
struct Jac {
  F X, Y, Z;  // Z == 0 encodes infinity
};

template <class F>
static inline void jac_set_inf(Jac<F> &p) {
  FOps<F>::set_one(p.X);
  FOps<F>::set_one(p.Y);
  FOps<F>::set_zero(p.Z);
}

template <class F>
static inline bool jac_is_inf(const Jac<F> &p) {
  return FOps<F>::is_zero(p.Z);
}

template <class F>
static inline void jac_from_aff(Jac<F> &r, const Aff<F> &a) {
  if (a.inf) {
    jac_set_inf(r);
    return;
  }
  r.X = a.x;
  r.Y = a.y;
  FOps<F>::set_one(r.Z);
}

// dbl-2009-l (a = 0)
template <class F>
static void jac_dbl(Jac<F> &r, const Jac<F> &p) {
  typedef FOps<F> O;
  if (jac_is_inf(p)) {
    r = p;
    return;
  }
  F A, B, C, D, E, Fv, t0, t1;
  O::sqr(A, p.X);
  O::sqr(B, p.Y);
  O::sqr(C, B);
  // D = 2((X+B)^2 - A - C)
  O::add(t0, p.X, B);
  O::sqr(t0, t0);
  O::sub(t0, t0, A);
  O::sub(t0, t0, C);
  O::dbl(D, t0);
  // E = 3A
  O::dbl(E, A);
  O::add(E, E, A);
  O::sqr(Fv, E);
  // X3 = F - 2D
  F X3, Y3, Z3;
  O::dbl(t0, D);
  O::sub(X3, Fv, t0);
  // Y3 = E(D - X3) - 8C
  O::sub(t0, D, X3);
  O::mul(t0, E, t0);
  O::dbl(t1, C);
  O::dbl(t1, t1);
  O::dbl(t1, t1);
  O::sub(Y3, t0, t1);
  // Z3 = 2 Y Z
  O::mul(t0, p.Y, p.Z);
  O::dbl(Z3, t0);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// madd-2007-bl: Jacobian + affine
template <class F>
static void jac_add_aff(Jac<F> &r, const Jac<F> &p, const Aff<F> &q) {
  typedef FOps<F> O;
  if (q.inf) {
    r = p;
    return;
  }
  if (jac_is_inf(p)) {
    jac_from_aff(r, q);
    return;
  }
  F Z1Z1, U2, S2, H, HH, I, J, rr, V, t0, t1;
  O::sqr(Z1Z1, p.Z);
  O::mul(U2, q.x, Z1Z1);
  O::mul(t0, p.Z, Z1Z1);
  O::mul(S2, q.y, t0);
  O::sub(H, U2, p.X);
  O::sub(t1, S2, p.Y);
  if (O::is_zero(H)) {
    if (O::is_zero(t1)) {
      jac_dbl(r, p);
      return;
    }
    jac_set_inf(r);
    return;
  }
  O::sqr(HH, H);
  O::dbl(I, HH);
  O::dbl(I, I);
  O::mul(J, H, I);
  O::dbl(rr, t1);
  O::mul(V, p.X, I);
  F X3, Y3, Z3;
  O::sqr(t0, rr);
  O::sub(t0, t0, J);
  O::dbl(t1, V);
  O::sub(X3, t0, t1);
  O::sub(t0, V, X3);
  O::mul(t0, rr, t0);
  O::mul(t1, p.Y, J);
  O::dbl(t1, t1);
  O::sub(Y3, t0, t1);
  O::add(t0, p.Z, H);
  O::sqr(t0, t0);
  O::sub(t0, t0, Z1Z1);
  O::sub(Z3, t0, HH);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

// add-2007-bl: full Jacobian addition
template <class F>
static void jac_add(Jac<F> &r, const Jac<F> &p, const Jac<F> &q) {
  typedef FOps<F> O;
  if (jac_is_inf(p)) {
    r = q;
    return;
  }
  if (jac_is_inf(q)) {
    r = p;
    return;
  }
  F Z1Z1, Z2Z2, U1, U2, S1, S2, H, I, J, rr, V, t0, t1;
  O::sqr(Z1Z1, p.Z);
  O::sqr(Z2Z2, q.Z);
  O::mul(U1, p.X, Z2Z2);
  O::mul(U2, q.X, Z1Z1);
  O::mul(t0, q.Z, Z2Z2);
  O::mul(S1, p.Y, t0);
  O::mul(t0, p.Z, Z1Z1);
  O::mul(S2, q.Y, t0);
  O::sub(H, U2, U1);
  O::sub(t1, S2, S1);
  if (O::is_zero(H)) {
    if (O::is_zero(t1)) {
      jac_dbl(r, p);
      return;
    }
    jac_set_inf(r);
    return;
  }
  O::dbl(t0, H);
  O::sqr(I, t0);
  O::mul(J, H, I);
  O::dbl(rr, t1);
  O::mul(V, U1, I);
  F X3, Y3, Z3;
  O::sqr(t0, rr);
  O::sub(t0, t0, J);
  O::dbl(t1, V);
  O::sub(X3, t0, t1);
  O::sub(t0, V, X3);
  O::mul(t0, rr, t0);
  O::mul(t1, S1, J);
  O::dbl(t1, t1);
  O::sub(Y3, t0, t1);
  O::add(t0, p.Z, q.Z);
  O::sqr(t0, t0);
  O::sub(t0, t0, Z1Z1);
  O::sub(t0, t0, Z2Z2);
  O::mul(Z3, t0, H);
  r.X = X3;
  r.Y = Y3;
  r.Z = Z3;
}

template <class F>
static void jac_to_aff(Aff<F> &r, const Jac<F> &p) {
  typedef FOps<F> O;
  if (jac_is_inf(p)) {
    r.inf = true;
    O::set_zero(r.x);
    O::set_zero(r.y);
    return;
  }
  F zinv, zinv2, zinv3;
  O::inv(zinv, p.Z);
  O::sqr(zinv2, zinv);
  O::mul(zinv3, zinv2, zinv);
  O::mul(r.x, p.X, zinv2);
  O::mul(r.y, p.Y, zinv3);
  r.inf = false;
}

// scalar mul (double-and-add, exponent canonical LE limbs)
template <class F>
static void jac_scalar_mul(Jac<F> &r, const Aff<F> &p, const uint64_t *e,
                           int nlimbs) {
  Jac<F> res;
  jac_set_inf(res);
  // MSB-first
  int top = nlimbs * 64 - 1;
  while (top >= 0 && !((e[top / 64] >> (top % 64)) & 1)) top--;
  for (int b = top; b >= 0; b--) {
    jac_dbl(res, res);
    if ((e[b / 64] >> (b % 64)) & 1) jac_add_aff(res, res, p);
  }
  r = res;
}

// ---------------------------------------------------------------------------
// Pippenger MSM (threaded by point chunks)
// ---------------------------------------------------------------------------

static int pick_window(size_t n) {
  if (n < 32) return 3;
  int c = 1;
  size_t t = n;
  while (t > 1) {
    t >>= 1;
    c++;
  }
  // ~log2(n) - 2, clamped
  c = c - 2;
  if (c < 4) c = 4;
  if (c > 16) c = 16;
  return c;
}

template <class F>
static void msm_chunk(const Aff<F> *pts, const uint8_t *scalars, size_t n,
                      int c, Jac<F> &out) {
  int nwin = (256 + c - 1) / c;
  size_t nbuckets = ((size_t)1 << c) - 1;
  std::vector<Jac<F>> buckets(nbuckets);
  Jac<F> acc;
  jac_set_inf(acc);
  for (int w = nwin - 1; w >= 0; w--) {
    if (w != nwin - 1)
      for (int k = 0; k < c; k++) jac_dbl(acc, acc);
    for (size_t b = 0; b < nbuckets; b++) jac_set_inf(buckets[b]);
    int bit0 = w * c;
    for (size_t i = 0; i < n; i++) {
      if (pts[i].inf) continue;
      const uint64_t *s = (const uint64_t *)(scalars + 32 * i);
      // extract c bits starting at bit0
      uint64_t digit = 0;
      int limb = bit0 / 64, off = bit0 % 64;
      digit = s[limb] >> off;
      if (off + c > 64 && limb + 1 < 4) digit |= s[limb + 1] << (64 - off);
      digit &= (((uint64_t)1 << c) - 1);
      if (digit == 0) continue;
      jac_add_aff(buckets[digit - 1], buckets[digit - 1], pts[i]);
    }
    // running-sum reduction
    Jac<F> running, sum;
    jac_set_inf(running);
    jac_set_inf(sum);
    for (size_t b = nbuckets; b-- > 0;) {
      jac_add(running, running, buckets[b]);
      jac_add(sum, sum, running);
    }
    jac_add(acc, acc, sum);
  }
  out = acc;
}

static int num_threads() {
  unsigned hc = std::thread::hardware_concurrency();
  return hc == 0 ? 4 : (int)hc;
}

template <class F>
static void msm_impl(const Aff<F> *pts, const uint8_t *scalars, size_t n,
                     Aff<F> &out) {
  int c = pick_window(n);
  int nt = num_threads();
  if ((size_t)nt * 256 > n) nt = (int)(n / 256) + 1;
  if (nt < 1) nt = 1;
  std::vector<Jac<F>> partial(nt);
  std::vector<std::thread> threads;
  size_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) {
      jac_set_inf(partial[t]);
      continue;
    }
    threads.emplace_back([&, t, lo, hi]() {
      msm_chunk(pts + lo, scalars + 32 * lo, hi - lo, c, partial[t]);
    });
  }
  for (auto &th : threads) th.join();
  Jac<F> acc;
  jac_set_inf(acc);
  for (int t = 0; t < nt; t++) jac_add(acc, acc, partial[t]);
  jac_to_aff(out, acc);
}

// ---------------------------------------------------------------------------
// Pairing: affine Miller loop with batch inversion, digit-based final exp
// ---------------------------------------------------------------------------

// Batch-invert n Fq2 elements in place (Montgomery's trick; zero entries
// are passed through untouched and flagged).
static void fq2_batch_inv(Fq2 *xs, size_t n) {
  std::vector<Fq2> prefix(n);
  Fq2 acc = FQ2_ONE;
  for (size_t i = 0; i < n; i++) {
    prefix[i] = acc;
    if (!fq2_is_zero(xs[i])) fq2_mul(acc, acc, xs[i]);
  }
  Fq2 inv;
  fq2_inv(inv, acc);
  for (size_t i = n; i-- > 0;) {
    if (fq2_is_zero(xs[i])) continue;
    Fq2 cur;
    fq2_mul(cur, prefix[i], inv);
    fq2_mul(inv, inv, xs[i]);
    xs[i] = cur;
  }
}

// line assembly per curves/pairing.py:_sparse_line —
// l = yp - (lam*xp) w - (yT - lam xT) w^3, basis w^0 -> c0.c0, w -> c1.c0,
// w^3 -> c1.c1.  f *= l.
static void mul_by_line(Fq12 &f, const Fq2 &lam, const Fq2 &c0l,
                        const Fq &xp, const Fq &yp) {
  Fq12 l;
  l.c0 = FQ6_ZERO;
  l.c0.c0.c0 = yp;
  l.c0.c0.c1 = FQ_ZERO;
  Fq2 lx;
  fq2_mul_fq(lx, lam, xp);
  fq2_neg(lx, lx);
  Fq2 nc0;
  fq2_neg(nc0, c0l);
  l.c1.c0 = lx;
  l.c1.c1 = nc0;
  l.c1.c2 = FQ2_ZERO;
  fq12_mul(f, f, l);
}

// Multi-Miller over a chunk of pairs with shared squaring chain and batch
// inversion per step (affine G2 coordinates, as the Python reference).
static void multi_miller_chunk(const Aff<Fq> *ps, const Aff<Fq2> *qs, size_t n,
                               Fq12 &out) {
  std::vector<size_t> live;
  live.reserve(n);
  for (size_t i = 0; i < n; i++)
    if (!ps[i].inf && !qs[i].inf) live.push_back(i);
  Fq12 f = FQ12_ONE;
  if (live.empty()) {
    out = f;
    return;
  }
  size_t m = live.size();
  std::vector<Fq2> tx(m), ty(m), denoms(m);
  for (size_t k = 0; k < m; k++) {
    tx[k] = qs[live[k]].x;
    ty[k] = qs[live[k]].y;
  }
  std::vector<bool> done(m, false);  // degenerate guard (never hit for valid input)

  int top = 63;
  while (top >= 0 && !((X_SEED >> top) & 1)) top--;
  for (int b = top - 1; b >= 0; b--) {
    fq12_sqr(f, f);
    // double step: lam = 3 x^2 / 2y
    for (size_t k = 0; k < m; k++) {
      if (done[k]) {
        denoms[k] = FQ2_ZERO;
        continue;
      }
      fq2_dbl(denoms[k], ty[k]);
    }
    fq2_batch_inv(denoms.data(), m);
    for (size_t k = 0; k < m; k++) {
      if (done[k]) continue;
      if (fq2_is_zero(denoms[k])) {
        done[k] = true;
        continue;
      }
      Fq2 x2, lam, c0l, x3, y3, t;
      fq2_sqr(x2, tx[k]);
      Fq2 x2_3;
      fq2_dbl(x2_3, x2);
      fq2_add(x2_3, x2_3, x2);
      fq2_mul(lam, x2_3, denoms[k]);
      // c0 = yT - lam xT
      fq2_mul(t, lam, tx[k]);
      fq2_sub(c0l, ty[k], t);
      // 2T
      fq2_sqr(x3, lam);
      fq2_sub(x3, x3, tx[k]);
      fq2_sub(x3, x3, tx[k]);
      fq2_sub(t, tx[k], x3);
      fq2_mul(y3, lam, t);
      fq2_sub(y3, y3, ty[k]);
      const Aff<Fq> &p = ps[live[k]];
      mul_by_line(f, lam, c0l, p.x, p.y);
      tx[k] = x3;
      ty[k] = y3;
    }
    if ((X_SEED >> b) & 1) {
      // add step: lam = (yQ - yT) / (xQ - xT)
      for (size_t k = 0; k < m; k++) {
        if (done[k]) {
          denoms[k] = FQ2_ZERO;
          continue;
        }
        fq2_sub(denoms[k], qs[live[k]].x, tx[k]);
      }
      fq2_batch_inv(denoms.data(), m);
      for (size_t k = 0; k < m; k++) {
        if (done[k]) continue;
        if (fq2_is_zero(denoms[k])) {
          done[k] = true;
          continue;
        }
        const Aff<Fq2> &q = qs[live[k]];
        Fq2 lam, c0l, x3, y3, t;
        fq2_sub(t, q.y, ty[k]);
        fq2_mul(lam, t, denoms[k]);
        fq2_mul(t, lam, tx[k]);
        fq2_sub(c0l, ty[k], t);
        fq2_sqr(x3, lam);
        fq2_sub(x3, x3, tx[k]);
        fq2_sub(x3, x3, q.x);
        fq2_sub(t, tx[k], x3);
        fq2_mul(y3, lam, t);
        fq2_sub(y3, y3, ty[k]);
        const Aff<Fq> &p = ps[live[k]];
        mul_by_line(f, lam, c0l, p.x, p.y);
        tx[k] = x3;
        ty[k] = y3;
      }
    }
  }
  out = f;
}

static void final_exponentiation(Fq12 &r, const Fq12 &f) {
  // easy part: f^((p^6-1)(p^2+1))
  Fq12 finv, f1, f2;
  fq12_inv(finv, f);
  Fq12 fc;
  fq12_conj(fc, f);
  fq12_mul(f1, fc, finv);
  fq12_frobenius(f2, f1, 2);
  fq12_mul(f2, f2, f1);
  // hard part via base-p digits (value-identical to curves/pairing.py)
  Fq12 res = FQ12_ONE;
  for (int i = 0; i < HARD_DIGITS_N; i++) {
    Fq12 md, mdf;
    fq12_pow_limbs(md, f2, HARD_DIGITS[i], 6);
    fq12_frobenius(mdf, md, i);
    fq12_mul(res, res, mdf);
  }
  r = res;
}

static void multi_pairing_impl(const Aff<Fq> *ps, const Aff<Fq2> *qs, size_t n,
                               Fq12 &out) {
  int nt = num_threads();
  if ((size_t)nt > (n + 7) / 8) nt = (int)((n + 7) / 8);
  if (nt < 1) nt = 1;
  std::vector<Fq12> partial(nt);
  std::vector<std::thread> threads;
  size_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    size_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) {
      partial[t] = FQ12_ONE;
      continue;
    }
    threads.emplace_back(
        [&, t, lo, hi]() { multi_miller_chunk(ps + lo, qs + lo, hi - lo, partial[t]); });
  }
  for (auto &th : threads) th.join();
  Fq12 f = FQ12_ONE;
  for (int t = 0; t < nt; t++) fq12_mul(f, f, partial[t]);
  final_exponentiation(out, f);
}

// ---------------------------------------------------------------------------
// Byte codecs
// ---------------------------------------------------------------------------

static void fq_read(Fq &r, const uint8_t *b) {
  uint64_t limbs[6];
  memcpy(limbs, b, 48);
  fq_from_canon(r, limbs);
}

static void fq_write(uint8_t *b, const Fq &a) {
  uint64_t limbs[6];
  fq_to_canon(limbs, a);
  memcpy(b, limbs, 48);
}

static void fq2_read(Fq2 &r, const uint8_t *b) {
  fq_read(r.c0, b);
  fq_read(r.c1, b + 48);
}
static void fq2_write(uint8_t *b, const Fq2 &a) {
  fq_write(b, a.c0);
  fq_write(b + 48, a.c1);
}

static void g1_read(Aff<Fq> &r, const uint8_t *b) {
  fq_read(r.x, b);
  fq_read(r.y, b + 48);
  r.inf = fq_is_zero(r.x) && fq_is_zero(r.y);
}
static void g1_write(uint8_t *b, const Aff<Fq> &a) {
  if (a.inf) {
    memset(b, 0, 96);
    return;
  }
  fq_write(b, a.x);
  fq_write(b + 48, a.y);
}

static void g2_read(Aff<Fq2> &r, const uint8_t *b) {
  fq2_read(r.x, b);
  fq2_read(r.y, b + 96);
  r.inf = fq2_is_zero(r.x) && fq2_is_zero(r.y);
}
static void g2_write(uint8_t *b, const Aff<Fq2> &a) {
  if (a.inf) {
    memset(b, 0, 192);
    return;
  }
  fq2_write(b, a.x);
  fq2_write(b + 96, a.y);
}

// Fq12 layout: nesting order (c0|c1)(c0|c1|c2)(c0|c1), 12 x 48 bytes
static void fq12_read(Fq12 &r, const uint8_t *b) {
  Fq2 *cs[6] = {&r.c0.c0, &r.c0.c1, &r.c0.c2, &r.c1.c0, &r.c1.c1, &r.c1.c2};
  for (int i = 0; i < 6; i++) fq2_read(*cs[i], b + 96 * i);
}
static void fq12_write(uint8_t *b, const Fq12 &a) {
  const Fq2 *cs[6] = {&a.c0.c0, &a.c0.c1, &a.c0.c2,
                      &a.c1.c0, &a.c1.c1, &a.c1.c2};
  for (int i = 0; i < 6; i++) fq2_write(b + 96 * i, *cs[i]);
}

// exponent bytes (arbitrary length LE) -> limb vector
static std::vector<uint64_t> exp_limbs(const uint8_t *e, int64_t len) {
  size_t nl = (len + 7) / 8;
  if (nl == 0) nl = 1;
  std::vector<uint64_t> limbs(nl, 0);
  memcpy(limbs.data(), e, len);
  return limbs;
}

// ---------------------------------------------------------------------------
// Init
// ---------------------------------------------------------------------------

static bool g_initialized = false;

static void init_constants() {
  if (g_initialized) return;
  // bootstrap: R2 as a raw Montgomery operand (R2 canonical == (R^2 mod p),
  // and mont_mul(a_raw, R2) = a*R mod p)
  for (int i = 0; i < 6; i++) FQ_R2M.v[i] = FQ_R2[i];
  for (int i = 0; i < 6; i++) FQ_ONE.v[i] = FQ_R[i];
  {
    uint64_t qnr_limbs[6];
    for (int i = 0; i < 6; i++) qnr_limbs[i] = QNR[i];
    fq_from_canon(QNR_M, qnr_limbs);
  }
  FQ2_ZERO.c0 = FQ_ZERO;
  FQ2_ZERO.c1 = FQ_ZERO;
  FQ2_ONE.c0 = FQ_ONE;
  FQ2_ONE.c1 = FQ_ZERO;
  FQ6_ZERO.c0 = FQ2_ZERO;
  FQ6_ZERO.c1 = FQ2_ZERO;
  FQ6_ZERO.c2 = FQ2_ZERO;
  FQ6_ONE.c0 = FQ2_ONE;
  FQ6_ONE.c1 = FQ2_ZERO;
  FQ6_ONE.c2 = FQ2_ZERO;
  FQ12_ONE.c0 = FQ6_ONE;
  FQ12_ONE.c1 = FQ6_ZERO;
  for (int i = 0; i < 6; i++) {
    fq_from_canon(FROB6C1_M[i].c0, FROB6_C1[i][0]);
    fq_from_canon(FROB6C1_M[i].c1, FROB6_C1[i][1]);
    fq_from_canon(FROB6C2_M[i].c0, FROB6_C2[i][0]);
    fq_from_canon(FROB6C2_M[i].c1, FROB6_C2[i][1]);
  }
  for (int i = 0; i < 12; i++) {
    fq_from_canon(FROB12C1_M[i].c0, FROB12_C1[i][0]);
    fq_from_canon(FROB12C1_M[i].c1, FROB12_C1[i][1]);
  }
  g_initialized = true;
}

}  // namespace tn

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

using namespace tn;

extern "C" {

int tn_version() { return 1; }

int tn_nthreads() { return num_threads(); }

void tn_init() { init_constants(); }

// points: n * 96 bytes (x||y LE canonical), scalars: n * 32 bytes LE
void tn_g1_msm(const uint8_t *pts, const uint8_t *scalars, int64_t n,
               uint8_t *out96) {
  init_constants();
  std::vector<Aff<Fq>> ps(n);
  for (int64_t i = 0; i < n; i++) g1_read(ps[i], pts + 96 * i);
  Aff<Fq> res;
  msm_impl(ps.data(), scalars, n, res);
  g1_write(out96, res);
}

void tn_g2_msm(const uint8_t *pts, const uint8_t *scalars, int64_t n,
               uint8_t *out192) {
  init_constants();
  std::vector<Aff<Fq2>> ps(n);
  for (int64_t i = 0; i < n; i++) g2_read(ps[i], pts + 192 * i);
  Aff<Fq2> res;
  msm_impl(ps.data(), scalars, n, res);
  g2_write(out192, res);
}

void tn_multi_pairing(const uint8_t *g1s, const uint8_t *g2s, int64_t n,
                      uint8_t *out576) {
  init_constants();
  std::vector<Aff<Fq>> ps(n);
  std::vector<Aff<Fq2>> qs(n);
  for (int64_t i = 0; i < n; i++) {
    g1_read(ps[i], g1s + 96 * i);
    g2_read(qs[i], g2s + 192 * i);
  }
  Fq12 res;
  multi_pairing_impl(ps.data(), qs.data(), n, res);
  fq12_write(out576, res);
}

void tn_gt_pow(const uint8_t *gt576, const uint8_t *exp_le, int64_t explen,
               uint8_t *out576) {
  init_constants();
  Fq12 a, r;
  fq12_read(a, gt576);
  auto limbs = exp_limbs(exp_le, explen);
  fq12_pow_limbs(r, a, limbs.data(), (int)limbs.size());
  fq12_write(out576, r);
}

// batch GT exponentiation: out[i] = gt[i]^scalar[i] (threaded); the MIPP
// verifier's T-fold raises 2*log2(n) GT elements at once (mipp.rs:240-277
// runs the same fold under par_iter).
void tn_gt_batch_pow(const uint8_t *gts, const uint8_t *scalars32, int64_t n,
                     uint8_t *out) {
  init_constants();
  int nt = num_threads();
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) continue;
    threads.emplace_back([=]() {
      for (int64_t i = lo; i < hi; i++) {
        Fq12 a, r;
        fq12_read(a, gts + 576 * i);
        fq12_pow_limbs(r, a, (const uint64_t *)(scalars32 + 32 * i), 4);
        fq12_write(out + 576 * i, r);
      }
    });
  }
  for (auto &th : threads) th.join();
}

void tn_gt_mul(const uint8_t *a576, const uint8_t *b576, uint8_t *out576) {
  init_constants();
  Fq12 a, b, r;
  fq12_read(a, a576);
  fq12_read(b, b576);
  fq12_mul(r, a, b);
  fq12_write(out576, r);
}

void tn_gt_inv(const uint8_t *a576, uint8_t *out576) {
  init_constants();
  Fq12 a, r;
  fq12_read(a, a576);
  fq12_inv(r, a);
  fq12_write(out576, r);
}

void tn_g1_mul(const uint8_t *pt96, const uint8_t *exp_le, int64_t explen,
               uint8_t *out96) {
  init_constants();
  Aff<Fq> p;
  g1_read(p, pt96);
  auto limbs = exp_limbs(exp_le, explen);
  Jac<Fq> j;
  jac_scalar_mul(j, p, limbs.data(), (int)limbs.size());
  Aff<Fq> r;
  jac_to_aff(r, j);
  g1_write(out96, r);
}

void tn_g2_mul(const uint8_t *pt192, const uint8_t *exp_le, int64_t explen,
               uint8_t *out192) {
  init_constants();
  Aff<Fq2> p;
  g2_read(p, pt192);
  auto limbs = exp_limbs(exp_le, explen);
  Jac<Fq2> j;
  jac_scalar_mul(j, p, limbs.data(), (int)limbs.size());
  Aff<Fq2> r;
  jac_to_aff(r, j);
  g2_write(out192, r);
}

// batch fixed-point-free scalar muls: out[i] = scalar[i] * pt[i] (threaded);
// used for SRS setup powers where each base differs.
void tn_g1_batch_mul(const uint8_t *pts, const uint8_t *scalars32, int64_t n,
                     uint8_t *out) {
  init_constants();
  int nt = num_threads();
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) continue;
    threads.emplace_back([=]() {
      for (int64_t i = lo; i < hi; i++) {
        Aff<Fq> p;
        g1_read(p, pts + 96 * i);
        Jac<Fq> j;
        jac_scalar_mul(j, p, (const uint64_t *)(scalars32 + 32 * i), 4);
        Aff<Fq> r;
        jac_to_aff(r, j);
        g1_write(out + 96 * i, r);
      }
    });
  }
  for (auto &th : threads) th.join();
}

void tn_g2_batch_mul(const uint8_t *pts, const uint8_t *scalars32, int64_t n,
                     uint8_t *out) {
  init_constants();
  int nt = num_threads();
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) continue;
    threads.emplace_back([=]() {
      for (int64_t i = lo; i < hi; i++) {
        Aff<Fq2> p;
        g2_read(p, pts + 192 * i);
        Jac<Fq2> j;
        jac_scalar_mul(j, p, (const uint64_t *)(scalars32 + 32 * i), 4);
        Aff<Fq2> r;
        jac_to_aff(r, j);
        g2_write(out + 192 * i, r);
      }
    });
  }
  for (auto &th : threads) th.join();
}

}  // extern "C"
