// Fq2 = Fq[u] / (u^2 + 5) for the Hopper kernels: the coordinate field of
// BLS12-377 G2.  One element per thread, two Fq elements of 12 words each.
//
// Replaces the in-kernel Fq2 layer of the TPU kernels
// (testudo_tpu/tpu/pallas_curve.py:253-319 `_RowOpsFq2`: Karatsuba with the
// non-residue folded in by additions, `mul_b3`).  The TPU version carries
// static bounds of lazily reduced values (`RV`, `K_CARRY = 8`, the product
// cap ka kb p <= R): lazy.cuh's `LFq2` does that for the one-thread group
// law.  Here every Fq operation reduces strictly, so each component is
// canonical and equals, limb for limb, what the JAX package writes at a
// kernel's edge.
//
// Compiles as plain C++ too (csrc/host_check.cpp).
#pragma once
#include "fp.cuh"

typedef FqParams Fq;
#define FQN 12

// Montgomery form of k = (3 b2).c1 = -3/5 mod p, where b2 = 1/u is the
// curve constant of G2: b3 (a0 + a1 u) = (-5 k a1, k a0) = (3 a1, k a0).
// tests/test_torch_csrc.py checks the table against device/curve.py.
FP_TABLE u32 FQ_B3K[12] = {
    0x3333338fu, 0x81567333u, 0x9cccccfcu, 0xa9e00b73u, 0x82ed9e6eu, 0x7fad0250u,
    0x24aed052u, 0x2c18f48au, 0xf43c75cbu, 0xe25d7666u, 0x52ddddc9u, 0x00ad4befu};

struct Fq2 {
  u32 c0[FQN], c1[FQN];
};

FP_FN void fp2_zero(Fq2& r) {
  fp_zero<Fq>(r.c0);
  fp_zero<Fq>(r.c1);
}

FP_FN void fp2_one(Fq2& r) {
  fp_copy<Fq>(r.c0, FQ_ONE);
  fp_zero<Fq>(r.c1);
}

FP_FN void fp2_select(Fq2& r, bool c, const Fq2& a, const Fq2& b) {
  fp_select<Fq>(r.c0, c, a.c0, b.c0);
  fp_select<Fq>(r.c1, c, a.c1, b.c1);
}

FP_FN void fp2_add(Fq2& r, const Fq2& a, const Fq2& b) {
  fp_add<Fq>(r.c0, a.c0, b.c0);
  fp_add<Fq>(r.c1, a.c1, b.c1);
}

FP_FN void fp2_sub(Fq2& r, const Fq2& a, const Fq2& b) {
  fp_sub<Fq>(r.c0, a.c0, b.c0);
  fp_sub<Fq>(r.c1, a.c1, b.c1);
}

FP_FN void fp2_neg(Fq2& r, const Fq2& a) {
  Fq2 z;
  fp2_zero(z);
  fp2_sub(r, z, a);
}

// r = 3a
FP_FN void fp2_mul3(Fq2& r, const Fq2& a) {
  fp_mul3<Fq>(r.c0, a.c0);
  fp_mul3<Fq>(r.c1, a.c1);
}

// r = a b by Karatsuba on three Fq products: t0 = a0 b0, t1 = a1 b1,
// s = (a0 + a1)(b0 + b1); c1 = s - t0 - t1, c0 = t0 - 5 t1 (u^2 = -5: the
// sign matters).  A real call, like fp_mul and for the same reason: a G2
// add multiplies twelve times.  The NOTE at fp_mul holds here too.  r may
// alias a or b.
FP_CALL_FN void fp2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
  u32 sa[FQN], sb[FQN], t0[FQN], t1[FQN], s[FQN];
  fp_add<Fq>(sa, a.c0, a.c1);
  fp_add<Fq>(sb, b.c0, b.c1);
  fp_mul<Fq>(t0, a.c0, b.c0);
  fp_mul<Fq>(t1, a.c1, b.c1);
  fp_mul<Fq>(s, sa, sb);
  fp_sub<Fq>(s, s, t0);
  fp_sub<Fq>(r.c1, s, t1);
  fp_add<Fq>(s, t1, t1);
  fp_add<Fq>(s, s, s);
  fp_add<Fq>(s, s, t1);  // 5 t1
  fp_sub<Fq>(r.c0, t0, s);
}

// r = b3 a = (3 a1, k a0): note which slot each lands in.  r may alias a.
FP_FN void fp2_mul_b3(Fq2& r, const Fq2& a) {
  u32 k[FQN], t[FQN];
  fp_copy<Fq>(k, FQ_B3K);
  fp_mul3<Fq>(t, a.c1);
  fp_mul<Fq>(r.c1, a.c0, k);
  fp_copy<Fq>(r.c0, t);
}

// Element `lane` of a (rows, L) limb array: component c0 starts at limb row
// `row0`, c1 at `row0 + 24`.
FP_FN void fp2_load(Fq2& r, const int* base, long L, long lane, int row0) {
  fp_load<Fq>(r.c0, base, L, lane, row0);
  fp_load<Fq>(r.c1, base, L, lane, row0 + 2 * FQN);
}

FP_FN void fp2_store(int* base, long L, long lane, int row0, const Fq2& a) {
  fp_store<Fq>(base, L, lane, row0, a.c0);
  fp_store<Fq>(base, L, lane, row0 + 2 * FQN, a.c1);
}

// An element stored point-major: 48 consecutive int32 limbs (c0 then c1) at
// a 16-byte aligned address.
FP_FN void fp2_load_row(Fq2& r, const int* row) {
  fp_load_row<Fq>(r.c0, row);
  fp_load_row<Fq>(r.c1, row + 2 * FQN);
}
