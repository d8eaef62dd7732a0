// BLS12-377 group law for the Hopper kernels, once for both groups and both
// reductions, and the per-lane bodies of the packed EC kernels; the same
// formulas over BW6-761's 761-bit field (`Fq761Coord`, strict) for the
// group-law kernels of fp_group.cu.
//
// Replaces the fused EC kernel bodies of testudo_tpu/tpu/pallas_curve.py
// (:391-584, ops "add_mask", "add2", "step", "scan2", "scan2b", "bucket",
// "bucket_mixed", and the ladder of :733-749), which trace tpu/curve.py's
// staged RCB16 formulas over lazily reduced limb rows, for `ncomp = 1` (G1
// over Fq) and `ncomp = 2` (G2 over Fq2).  The formulas here are the same
// three (Renes-Costello-Batina 2016, a = 0: Algorithm 7 complete add,
// Algorithm 8 complete mixed add, Algorithm 9 complete double), and every
// coordinate written is canonical and equals, limb for limb, what the JAX
// package writes.
//
// The formulas are templates over a coordinate-field policy, as tpu/curve.py
// writes them once over an ops namespace, and return their point by value
// (each intermediate a new name, so its type may carry its own bound).  Two
// reductions:
//   - strict (`FqCoord`: one Fq element, b3 = 3; `Fq2Coord`: an Fq2
//     element, b3 = 3/u): every value canonical (fp.cuh, fp2.cuh).  The
//     kernel-phase bodies (add2, add_mask, step, scan2, scan2b, the one-thread
//     ladder) run it.
//   - lazy (`LazyFqCoord`, `LazyFq2Coord`, each strict policy's `Lazy`):
//     lazy.cuh's static bounds, a loop-carried point clamped to K_CARRY (4
//     for G1, 8 for G2, pallas_curve.py:154, :257) after every step, made
//     canonical at the store.  The bucket kernels and the one-thread
//     fixed-base kernels run it where it measured faster (BucketArith,
//     FixedBaseArith: all but G2's general add; the window kernel's mixed
//     add is the mixed bucket's).
// BW6-761's two groups have a strict policy each (`Fq761Coord<B>`, b = -1
// and 4) over FpGroup's row-major coordinates; they are at the end.
// A point is three coordinates in a thread's registers (and, for G2, local
// memory: two points and the temporaries of an add exceed 255 registers).
// In device memory a batch is `(C::ROWS, L)` int32: coordinate-major,
// component-major within a coordinate, 24 rows of 16-bit limbs per
// component, batch along L: 72 rows for G1, 144 for G2.
//
// Each `lane_*` function is the whole work of one thread of one kernel; the
// `__global__` functions in the .cu files only compute the lane index (the
// bucket kernel takes its lanes from a work counter).  The same functions
// compile as plain C++ for csrc/host_check.cpp.
#pragma once
#include "lazy.cuh"

// ---------------------------------------------------------------------------
// Points and coordinate-field policies
// ---------------------------------------------------------------------------
//
// A policy gives the formulas their field: add, sub, mul3 (3a), mul_b3 and
// select return values; `mul_to(r, a, b)` writes a product into r, of the
// policy's one product type `Prod` (the product is a real call that writes
// through its first argument: returning it by value cost the G2 kernels a
// copy through local memory, 30-40% of the strict ones' time on the H100);
// `point(x, y, z)` makes the formulas' result; `carry(P)` gives a
// loop-carried point its fixed type; `canon(P)` the canonical point a store
// writes.  `E` is the canonical coordinate (what load and load_row return,
// store takes), Pt<A> the canonical point.

template <class X>
struct PtE {
  X x, y, z;
};

template <class A>
using Pt = PtE<typename A::E>;

struct LazyFqCoord {
  typedef LFq<1> E;
  typedef LFq<2> Prod;
  static constexpr int K_CARRY = 4;
  static constexpr int COMP_ROWS = 2 * FQN;  // limb rows of one coordinate
  static constexpr int ROWS = 3 * COMP_ROWS;
  FP_MEMBER static E zero() {
    E r;
    fp_zero<Fq>(r.v);
    return r;
  }
  FP_MEMBER static E one() { return lz_of<1>(FQ_ONE); }
  template <int KA, int KB>
  FP_MEMBER static auto add(const LFq<KA>& a, const LFq<KB>& b) { return lz_add(a, b); }
  template <int KA, int KB>
  FP_MEMBER static auto sub(const LFq<KA>& a, const LFq<KB>& b) { return lz_sub(a, b); }
  template <int KA, int KB>
  FP_MEMBER static void mul_to(Prod& r, const LFq<KA>& a, const LFq<KB>& b) {
    lz_mul_to(r, a, b);
  }
  template <int K>
  FP_MEMBER static auto mul3(const LFq<K>& a) { return lz_smul<3>(a); }
  template <int K>
  FP_MEMBER static auto mul_b3(const LFq<K>& a) { return lz_smul<3>(a); }  // b3 = 3
  template <int KA, int KB>
  FP_MEMBER static auto select(bool c, const LFq<KA>& a, const LFq<KB>& b) {
    return lz_select(c, a, b);
  }
  template <int KX, int KY, int KZ>
  FP_MEMBER static auto point(const LFq<KX>& x, const LFq<KY>& y, const LFq<KZ>& z) {
    constexpr int K = lz_max(KX, lz_max(KY, KZ));
    return PtE<LFq<K>>{lz_relax<K>(x), lz_relax<K>(y), lz_relax<K>(z)};
  }
  template <int K>
  FP_MEMBER static PtE<LFq<K_CARRY>> carry(const PtE<LFq<K>>& a) {
    return {lz_clamp<K_CARRY>(a.x), lz_clamp<K_CARRY>(a.y), lz_clamp<K_CARRY>(a.z)};
  }
  template <int K>
  FP_MEMBER static PtE<E> canon(const PtE<LFq<K>>& a) {
    return {lz_finalize(a.x), lz_finalize(a.y), lz_finalize(a.z)};
  }
  FP_MEMBER static E load(const int* base, long L, long lane, int row0) {
    E r;
    fp_load<Fq>(r.v, base, L, lane, row0);
    return r;
  }
  FP_MEMBER static void store(int* base, long L, long lane, int row0, const E& a) {
    fp_store<Fq>(base, L, lane, row0, a.v);
  }
  FP_MEMBER static E load_row(const int* row) {
    E r;
    fp_load_row<Fq>(r.v, row);
    return r;
  }
};

struct LazyFq2Coord {
  typedef LFq2<1, 1> E;
  typedef LFq2<4, 4> Prod;
  static constexpr int K_CARRY = 8;
  static constexpr int COMP_ROWS = 4 * FQN;
  static constexpr int ROWS = 3 * COMP_ROWS;
  FP_MEMBER static E zero() { return {LazyFqCoord::zero(), LazyFqCoord::zero()}; }
  FP_MEMBER static E one() { return {LazyFqCoord::one(), LazyFqCoord::zero()}; }
  template <int A0, int A1, int B0, int B1>
  FP_MEMBER static auto add(const LFq2<A0, A1>& a, const LFq2<B0, B1>& b) {
    return lz2_add(a, b);
  }
  template <int A0, int A1, int B0, int B1>
  FP_MEMBER static auto sub(const LFq2<A0, A1>& a, const LFq2<B0, B1>& b) {
    return lz2_sub(a, b);
  }
  template <int A0, int A1, int B0, int B1>
  FP_MEMBER static void mul_to(Prod& r, const LFq2<A0, A1>& a, const LFq2<B0, B1>& b) {
    lz2_mul_to(r, a, b);
  }
  template <int K0, int K1>
  FP_MEMBER static auto mul3(const LFq2<K0, K1>& a) { return lz2_smul<3>(a); }
  template <int K0, int K1>
  FP_MEMBER static auto mul_b3(const LFq2<K0, K1>& a) { return lz2_mul_b3(a); }
  template <int A0, int A1, int B0, int B1>
  FP_MEMBER static auto select(bool c, const LFq2<A0, A1>& a, const LFq2<B0, B1>& b) {
    return lz2_select(c, a, b);
  }
  template <int X0, int X1, int Y0, int Y1, int Z0, int Z1>
  FP_MEMBER static auto point(const LFq2<X0, X1>& x, const LFq2<Y0, Y1>& y,
                              const LFq2<Z0, Z1>& z) {
    constexpr int K = lz_max(lz_max(lz_max(X0, X1), lz_max(Y0, Y1)), lz_max(Z0, Z1));
    return PtE<LFq2<K, K>>{lz2_relax<K>(x), lz2_relax<K>(y), lz2_relax<K>(z)};
  }
  template <int K>
  FP_MEMBER static PtE<LFq2<K_CARRY, K_CARRY>> carry(const PtE<LFq2<K, K>>& a) {
    return {lz2_clamp<K_CARRY>(a.x), lz2_clamp<K_CARRY>(a.y), lz2_clamp<K_CARRY>(a.z)};
  }
  template <int K>
  FP_MEMBER static PtE<E> canon(const PtE<LFq2<K, K>>& a) {
    return {lz2_finalize(a.x), lz2_finalize(a.y), lz2_finalize(a.z)};
  }
  FP_MEMBER static E load(const int* base, long L, long lane, int row0) {
    return {LazyFqCoord::load(base, L, lane, row0),
            LazyFqCoord::load(base, L, lane, row0 + 2 * FQN)};
  }
  FP_MEMBER static void store(int* base, long L, long lane, int row0, const E& a) {
    LazyFqCoord::store(base, L, lane, row0, a.c0);
    LazyFqCoord::store(base, L, lane, row0 + 2 * FQN, a.c1);
  }
  FP_MEMBER static E load_row(const int* row) {
    return {LazyFqCoord::load_row(row), LazyFqCoord::load_row(row + 2 * FQN)};
  }
};

struct FqCoord {
  struct E {
    u32 v[FQN];
  };
  typedef E Prod;
  typedef LazyFqCoord Lazy;
  static constexpr int COMP_ROWS = 2 * FQN;  // limb rows of one coordinate
  static constexpr int ROWS = 3 * COMP_ROWS;
  FP_MEMBER static E zero() {
    E r;
    fp_zero<Fq>(r.v);
    return r;
  }
  FP_MEMBER static E one() {
    E r;
    fp_copy<Fq>(r.v, FQ_ONE);
    return r;
  }
  FP_MEMBER static E select(bool c, const E& a, const E& b) {
    E r;
    fp_select<Fq>(r.v, c, a.v, b.v);
    return r;
  }
  FP_MEMBER static E add(const E& a, const E& b) {
    E r;
    fp_add<Fq>(r.v, a.v, b.v);
    return r;
  }
  FP_MEMBER static E sub(const E& a, const E& b) {
    E r;
    fp_sub<Fq>(r.v, a.v, b.v);
    return r;
  }
  FP_MEMBER static void mul_to(E& r, const E& a, const E& b) { fp_mul<Fq>(r.v, a.v, b.v); }
  FP_MEMBER static E mul3(const E& a) {
    E r;
    fp_mul3<Fq>(r.v, a.v);
    return r;
  }
  FP_MEMBER static E mul_b3(const E& a) { return mul3(a); }  // b3 = 3
  FP_MEMBER static PtE<E> point(const E& x, const E& y, const E& z) { return {x, y, z}; }
  FP_MEMBER static const PtE<E>& carry(const PtE<E>& a) { return a; }
  FP_MEMBER static const PtE<E>& canon(const PtE<E>& a) { return a; }
  FP_MEMBER static E load(const int* base, long L, long lane, int row0) {
    E r;
    fp_load<Fq>(r.v, base, L, lane, row0);
    return r;
  }
  FP_MEMBER static void store(int* base, long L, long lane, int row0, const E& a) {
    fp_store<Fq>(base, L, lane, row0, a.v);
  }
  FP_MEMBER static E load_row(const int* row) {
    E r;
    fp_load_row<Fq>(r.v, row);
    return r;
  }
};

struct Fq2Coord {
  typedef Fq2 E;
  typedef E Prod;
  typedef LazyFq2Coord Lazy;
  static constexpr int COMP_ROWS = 4 * FQN;
  static constexpr int ROWS = 3 * COMP_ROWS;
  FP_MEMBER static E zero() {
    E r;
    fp2_zero(r);
    return r;
  }
  FP_MEMBER static E one() {
    E r;
    fp2_one(r);
    return r;
  }
  FP_MEMBER static E select(bool c, const E& a, const E& b) {
    E r;
    fp2_select(r, c, a, b);
    return r;
  }
  FP_MEMBER static E add(const E& a, const E& b) {
    E r;
    fp2_add(r, a, b);
    return r;
  }
  FP_MEMBER static E sub(const E& a, const E& b) {
    E r;
    fp2_sub(r, a, b);
    return r;
  }
  FP_MEMBER static void mul_to(E& r, const E& a, const E& b) { fp2_mul(r, a, b); }
  FP_MEMBER static E mul3(const E& a) {
    E r;
    fp2_mul3(r, a);
    return r;
  }
  FP_MEMBER static E mul_b3(const E& a) {
    E r;
    fp2_mul_b3(r, a);
    return r;
  }
  FP_MEMBER static PtE<E> point(const E& x, const E& y, const E& z) { return {x, y, z}; }
  FP_MEMBER static const PtE<E>& carry(const PtE<E>& a) { return a; }
  FP_MEMBER static const PtE<E>& canon(const PtE<E>& a) { return a; }
  FP_MEMBER static E load(const int* base, long L, long lane, int row0) {
    E r;
    fp2_load(r, base, L, lane, row0);
    return r;
  }
  FP_MEMBER static void store(int* base, long L, long lane, int row0, const E& a) {
    fp2_store(base, L, lane, row0, a);
  }
  FP_MEMBER static E load_row(const int* row) {
    E r;
    fp2_load_row(r, row);
    return r;
  }
};

// BW6-761's two groups (device/curve_generic.py `FpGroup`): G1 (b = -1) and
// G2 (b = 4, the sextic twist), both over the 761-bit base field, one strict
// policy a group.  An element is 24 words (96 bytes, as large as an Fq2
// element) and every value is canonical, as in the plain `FpGroup` and in the
// JAX package, which has no lazy layer for this field: the kernels' limbs are
// theirs, limb for limb.  mul_b3 is the product by 3b done with sums, -3a for
// G1 and 12a for G2: the value the product by the constant 3b gives.  Points
// are in FpGroup's layout, three (n, 48) int32 arrays of 16-bit limbs (a
// coordinate's limbs contiguous, `load_row` / `store_row`).
template <int B>
struct Fq761Coord {
  static_assert(B == -1 || B == 4, "BW6-761's G1 has b = -1, its G2 b = 4");
  typedef Fq761Params F;
  struct E {
    u32 v[F::N];
  };
  typedef E Prod;
  static constexpr int ROW = 2 * F::N;  // int32 limbs of one coordinate
  FP_MEMBER static E zero() {
    E r;
    fp_zero<F>(r.v);
    return r;
  }
  FP_MEMBER static E one() {
    E r;
    fp_copy<F>(r.v, FQ761_ONE);
    return r;
  }
  FP_MEMBER static E select(bool c, const E& a, const E& b) {
    E r;
    fp_select<F>(r.v, c, a.v, b.v);
    return r;
  }
  FP_MEMBER static E add(const E& a, const E& b) {
    E r;
    fp_add<F>(r.v, a.v, b.v);
    return r;
  }
  FP_MEMBER static E sub(const E& a, const E& b) {
    E r;
    fp_sub<F>(r.v, a.v, b.v);
    return r;
  }
  FP_MEMBER static void mul_to(E& r, const E& a, const E& b) { fp_mul<F>(r.v, a.v, b.v); }
  FP_MEMBER static E mul3(const E& a) {
    E r;
    fp_mul3<F>(r.v, a.v);
    return r;
  }
  FP_MEMBER static E mul_b3(const E& a) {
    E r = mul3(a);
    if constexpr (B == -1) {
      r = sub(zero(), r);  // -3a
    } else {
      r = add(r, r);
      r = add(r, r);  // 12a
    }
    return r;
  }
  FP_MEMBER static PtE<E> point(const E& x, const E& y, const E& z) { return {x, y, z}; }
  FP_MEMBER static const PtE<E>& carry(const PtE<E>& a) { return a; }
  FP_MEMBER static const PtE<E>& canon(const PtE<E>& a) { return a; }
  FP_MEMBER static E load_row(const int* row) {
    E r;
    fp_load_row<F>(r.v, row);
    return r;
  }
  FP_MEMBER static void store_row(int* row, const E& a) { fp_store_row<F>(row, a.v); }
};

template <class A>
FP_FN Pt<A> ec_identity() {
  return {A::zero(), A::one(), A::zero()};
}

template <class A>
FP_FN Pt<A> ec_load(const int* base, long L, long lane) {
  return {A::load(base, L, lane, 0), A::load(base, L, lane, A::COMP_ROWS),
          A::load(base, L, lane, 2 * A::COMP_ROWS)};
}

// Canonical words of `a` at lane `lane` of a (A::ROWS, L) batch.
template <class A, class P>
FP_FN void ec_store(int* base, long L, long lane, const P& a) {
  const auto& c = A::canon(a);
  A::store(base, L, lane, 0, c.x);
  A::store(base, L, lane, A::COMP_ROWS, c.y);
  A::store(base, L, lane, 2 * A::COMP_ROWS, c.z);
}

template <class A, class P, class Q>
FP_FN auto ec_select(bool c, const P& a, const Q& b) {
  return A::point(A::select(c, a.x, b.x), A::select(c, a.y, b.y), A::select(c, a.z, b.z));
}

// ---------------------------------------------------------------------------
// The three formulas
// ---------------------------------------------------------------------------

// Shared tail of Algorithms 7 and 8: from t0 = X1X2, t1 = Y1Y2, t2 (Z1Z2 or
// Z1), t3, t4 and Y3 as staged in tpu/curve.py:199-213.
template <class A, class T0, class T1, class T2, class T3, class T4, class Y3>
FP_FN auto ec_add_tail(const T0& t0, const T1& t1, const T2& t2, const T3& t3, const T4& t4,
                       const Y3& y3) {
  const auto t0x3 = A::add(A::add(t0, t0), t0);  // 3 X1X2
  const auto t2b = A::mul_b3(t2);
  const auto y3b = A::mul_b3(y3);
  const auto z3 = A::add(t1, t2b);
  const auto t1b = A::sub(t1, t2b);
  typename A::Prod a1, a2, a3, a4, a5, a6;
  A::mul_to(a1, t4, y3b);
  A::mul_to(a2, t3, t1b);
  const auto x = A::sub(a2, a1);
  A::mul_to(a3, y3b, t0x3);
  A::mul_to(a4, t1b, z3);
  const auto y = A::add(a4, a3);
  A::mul_to(a5, t0x3, t3);
  A::mul_to(a6, z3, t4);
  return A::point(x, y, A::add(a6, a5));
}

// p + q, complete (RCB16 Algorithm 7).
template <class A, class P, class Q>
FP_FN auto ec_add(const P& p, const Q& q) {
  typename A::Prod t0, t1, t2, m3, m4, m5;
  A::mul_to(t0, p.x, q.x);
  A::mul_to(t1, p.y, q.y);
  A::mul_to(t2, p.z, q.z);
  A::mul_to(m3, A::add(p.x, p.y), A::add(q.x, q.y));
  A::mul_to(m4, A::add(p.y, p.z), A::add(q.y, q.z));
  A::mul_to(m5, A::add(p.x, p.z), A::add(q.x, q.z));
  const auto t3 = A::sub(m3, A::add(t0, t1));
  const auto t4 = A::sub(m4, A::add(t1, t2));
  const auto y3 = A::sub(m5, A::add(t0, t2));
  return ec_add_tail<A>(t0, t1, t2, t3, t4, y3);
}

// p + (x2, y2), complete mixed add (RCB16 Algorithm 8): the second point is
// affine and must not be the identity.
template <class A, class P, class X>
FP_FN auto ec_add_mixed(const P& p, const X& x2, const X& y2) {
  typename A::Prod t0, t1, m3, m4, m5;
  A::mul_to(t0, p.x, x2);
  A::mul_to(t1, p.y, y2);
  A::mul_to(m3, A::add(p.x, p.y), A::add(x2, y2));
  A::mul_to(m4, y2, p.z);
  A::mul_to(m5, x2, p.z);
  const auto t3 = A::sub(m3, A::add(t0, t1));
  const auto t4 = A::add(m4, p.y);
  const auto y3 = A::add(m5, p.x);
  return ec_add_tail<A>(t0, t1, p.z, t3, t4, y3);
}

// 2p, complete (RCB16 Algorithm 9).
template <class A, class P>
FP_FN auto ec_double(const P& p) {
  typename A::Prod t0, t1, t2, txy, b1, b2, b3, b4;
  A::mul_to(t0, p.y, p.y);
  A::mul_to(t1, p.y, p.z);
  A::mul_to(t2, p.z, p.z);
  A::mul_to(txy, p.x, p.y);
  const auto z2 = A::add(t0, t0);
  const auto z4 = A::add(z2, z2);
  const auto z3 = A::add(z4, z4);  // 8 Y^2
  const auto t2b = A::mul_b3(t2);
  const auto y3 = A::add(t0, t2b);
  const auto t0b = A::sub(t0, A::mul3(t2b));  // t0 - 3 t2b
  A::mul_to(b1, t2b, z3);
  A::mul_to(b2, t1, z3);
  A::mul_to(b3, t0b, y3);
  A::mul_to(b4, t0b, txy);
  return A::point(A::add(b4, b4), A::add(b1, b3), b2);
}

// ---------------------------------------------------------------------------
// Per-lane kernel bodies
// ---------------------------------------------------------------------------

// out = a + b
template <class C>
FP_FN void lane_add2(const int* a, const int* b, int* out, long L, long lane) {
  const Pt<C> p = ec_load<C>(a, L, lane), q = ec_load<C>(b, L, lane);
  ec_store<C>(out, L, lane, ec_add<C>(p, q));
}

// out = mask ? acc + pts : acc.  `pts` is a batch of L points, or ONE point
// (a single column, `shared`) that every lane adds: the fixed-base ladder's
// table column.  The add always runs and the mask selects.
template <class C>
FP_FN void lane_add_mask(const int* acc, const int* pts, const int* mask, int* out,
                         long L, bool shared, long lane) {
  const Pt<C> a = ec_load<C>(acc, L, lane);
  const Pt<C> b = ec_load<C>(pts, shared ? 1 : L, shared ? 0 : lane);
  ec_store<C>(out, L, lane, ec_select<C>(mask[lane] != 0, ec_add<C>(a, b), a));
}

// out_acc = mask ? acc + base : acc;  out_base = 2 base.  The add always
// runs and the mask selects, as in the plain version: a warp pays for the
// add as soon as one of its lanes is masked in.
template <class C>
FP_FN void lane_step(const int* acc, const int* base, const int* mask,
                     int* out_acc, int* out_base, long L, long lane) {
  const Pt<C> a = ec_load<C>(acc, L, lane), b = ec_load<C>(base, L, lane);
  ec_store<C>(out_acc, L, lane, ec_select<C>(mask[lane] != 0, ec_add<C>(a, b), a));
  ec_store<C>(out_base, L, lane, ec_double<C>(b));
}

// out_run = run + bl;  out_tot = tot + out_run (the new run: two dependent adds)
template <class C>
FP_FN void lane_scan2(const int* run, const int* tot, const int* bl,
                      int* out_run, int* out_tot, long L, long lane) {
  const Pt<C> r = ec_add<C>(ec_load<C>(run, L, lane), ec_load<C>(bl, L, lane));
  ec_store<C>(out_run, L, lane, r);
  ec_store<C>(out_tot, L, lane, ec_add<C>(ec_load<C>(tot, L, lane), r));
}

// out_run = run + bl;  out_tot = tot + run (the old run)
template <class C>
FP_FN void lane_scan2b(const int* run, const int* tot, const int* bl,
                       int* out_run, int* out_tot, long L, long lane) {
  const Pt<C> r = ec_load<C>(run, L, lane);
  ec_store<C>(out_run, L, lane, ec_add<C>(r, ec_load<C>(bl, L, lane)));
  ec_store<C>(out_tot, L, lane, ec_add<C>(ec_load<C>(tot, L, lane), r));
}

// Is `bit` set in any lane of this warp?  The answer is the same for every
// thread of the warp, so a branch on it never splits the warp.  (On the CPU
// build a lane runs as in a warp where another lane needs every step, so
// the select, not the skip, must keep its result: the harder case.)
FP_FN bool any_lane(bool bit) {
#ifdef __CUDACC__
  return __any_sync(__activemask(), bit) != 0;
#else
  (void)bit;
  return true;
#endif
}

// out = [s] P: LSB-first double-and-add over all 16 * nl scalar bits, acc
// and base held by the thread for the whole ladder.  scal is (nl, L)
// canonical 16-bit limbs.  A step adds then selects, as the plain version
// does; the add is skipped when no lane of the warp has the bit set, which
// changes no lane's result (the Horner combine's scalars 2^(c w) have one
// bit each).
template <class C>
FP_FN void lane_ladder(const int* pts, const int* scal, int* out, int nl, long L,
                       long lane) {
  Pt<C> acc = ec_identity<C>(), base = ec_load<C>(pts, L, lane);
  FP_NO_UNROLL
  for (int k = 0; k < nl; k++) {
    u32 limb = (u32)scal[(long)k * L + lane];
    FP_NO_UNROLL
    for (int bit = 0; bit < 16; bit++) {
      bool set = ((limb >> bit) & 1u) != 0;
      if (any_lane(set)) acc = ec_select<C>(set, ec_add<C>(acc, base), acc);
      base = ec_double<C>(base);
    }
  }
  ec_store<C>(out, L, lane, acc);
}

// The arithmetic the one-thread bodies run, a group and kernel each (their
// default A), as the H100 measured them against the strict bodies in one
// call (PERF.md): the lazy policy for G1's adds and G2's mixed add (bucket
// kernels -5% to -14%, G1 fixed-base -20%), the strict one for G2's general
// add, where two projective points and the lazy operands' halvings spill
// past 255 registers (its bucket +17%, its fixed-base +22% lazy).
template <class C, bool MIXED>
struct BucketArith {
  typedef typename C::Lazy A;
};
template <>
struct BucketArith<Fq2Coord, false> {
  typedef Fq2Coord A;
};
template <class C>
struct FixedBaseArith {
  typedef typename C::Lazy A;
};
template <>
struct FixedBaseArith<Fq2Coord> {
  typedef Fq2Coord A;
};

// out[lane] = [s] B by a table of doublings: acc = O; for k < 16 nl: acc =
// bit k of s ? acc + T_k : acc, with T_k column k of the packed (C::ROWS,
// 16 nl) table (2^k B) and s row `lane` of the (N, nl) canonical 16-bit
// limbs: the adds and selects of `add_mask`, the accumulator held by the
// thread for all 16 nl steps, in the arithmetic A (FixedBaseArith's unless a
// caller asks for another), clamped to A's K_CARRY after every step.  The
// add is skipped when no lane of the warp has the bit set, which changes no
// lane's result.
template <class C, class A = typename FixedBaseArith<C>::A>
FP_FN void lane_fixed_base(const int* table, const int* scal, int* out, long N, int nl,
                           long lane) {
  auto acc = A::carry(ec_identity<A>());
  FP_NO_UNROLL
  for (int l = 0; l < nl; l++) {
    u32 limb = (u32)scal[lane * nl + l];
    FP_NO_UNROLL
    for (int bit = 0; bit < 16; bit++) {
      bool set = ((limb >> bit) & 1u) != 0;
      if (any_lane(set)) {
        const Pt<A> t = ec_load<A>(table, 16L * nl, 16 * l + bit);
        acc = A::carry(ec_select<A>(set, ec_add<A>(acc, t), acc));
      }
    }
  }
  ec_store<A>(out, N, lane, acc);
}

#define FB_WINDOW 8  // scalar bits a window of either fixed-base table takes

// out[lane] = [s] B by the 2 nl 8-bit windows of s, row `lane` of the (N,
// nl) canonical 16-bit limbs: acc = O; for w < 2 nl, with d window w's
// digit, acc = d ? acc + T[w 256 + d] : acc, the complete mixed add with row
// w 256 + d of the point-major (2 nl 256, C::ROWS) table of affine lifts
// (d 2^(8 w) B; row w 256 holds 2^(8 w) B, a stand-in for d = 0 that is
// never kept; only X and Y are read), then the select.  The accumulator
// runs in the arithmetic A (the mixed bucket's: lazy for both groups) and
// is clamped to A's K_CARRY after every window.  A window is skipped where
// no lane of the warp has a nonzero digit, which changes no lane's result.
template <class C, class A = typename BucketArith<C, true>::A>
FP_FN void lane_fixed_base_window(const int* table, const int* scal, int* out, long N, int nl,
                                  long lane) {
  auto acc = A::carry(ec_identity<A>());
  FP_NO_UNROLL
  for (int w = 0; w < 2 * nl; w++) {
    const u32 limb = (u32)scal[lane * nl + w / 2];
    const u32 d = (limb >> (FB_WINDOW * (w & 1))) & ((1u << FB_WINDOW) - 1u);
    if (any_lane(d != 0)) {
      const int* row = table + (((long)w << FB_WINDOW) + d) * A::ROWS;
      const typename A::E x2 = A::load_row(row), y2 = A::load_row(row + A::COMP_ROWS);
      acc = A::carry(ec_select<A>(d != 0, ec_add_mixed<A>(acc, x2, y2), acc));
    }
  }
  ec_store<A>(out, N, lane, acc);
}

// out[lane] = sum over t < count[lane] of table[src(start[lane] + t)], added
// in order onto the identity.  table is point-major, `(rows, C::ROWS)` int32;
// src(i) = idx[i] when idx != nullptr (the sorted-index table of the bucket
// phase), else i itself (consecutive rows: the segment reduce).  MIXED reads
// only X and Y of each row and runs the mixed add: the rows must be affine
// lifts (Z = R mod p) and never the identity.  A lane with count 0 returns
// the identity.  The accumulator runs in the arithmetic A (BucketArith's
// unless a caller asks for another) and is clamped to A's K_CARRY after
// every add (pallas_curve.py:494), so its type is the same at every step.
template <class C, bool MIXED, class A = typename BucketArith<C, MIXED>::A>
FP_FN void lane_bucket(const int* table, const int* idx, const int* start,
                       const int* count, int* out, long L, long lane) {
  auto acc = A::carry(ec_identity<A>());
  long pos = start[lane];
  int n = count[lane];
  FP_NO_UNROLL
  for (int t = 0; t < n; t++) {
    long src = idx ? (long)idx[pos + t] : pos + t;
    const int* row = table + src * A::ROWS;
    if (MIXED) {
      const typename A::E x2 = A::load_row(row), y2 = A::load_row(row + A::COMP_ROWS);
      acc = A::carry(ec_add_mixed<A>(acc, x2, y2));
    } else {
      const Pt<A> q = {A::load_row(row), A::load_row(row + A::COMP_ROWS),
                       A::load_row(row + 2 * A::COMP_ROWS)};
      acc = A::carry(ec_add<A>(acc, q));
    }
  }
  ec_store<A>(out, L, lane, acc);
}

// ---------------------------------------------------------------------------
// BW6-761's group law, a thread a lane (csrc/fp_group.cu)
// ---------------------------------------------------------------------------
//
// The bodies of the kernels under `FpGroup` (device/curve_generic.py), each
// over a Fq761Coord<B> policy A: the elementwise add, mixed add and double,
// the chunk sums of `msm_fp`'s bucket runs and `fixed_base_mul`.  A point is
// element `i` of three (n, 48) int32 arrays, one a coordinate.

enum FpgOp { FPG_ADD = 0, FPG_ADD_MIXED = 1, FPG_DOUBLE = 2 };

template <class A>
FP_FN Pt<A> fpg_load(const int* x, const int* y, const int* z, long i) {
  return {A::load_row(x + i * A::ROW), A::load_row(y + i * A::ROW),
          A::load_row(z + i * A::ROW)};
}

template <class A>
FP_FN void fpg_store(int* x, int* y, int* z, long i, const Pt<A>& p) {
  A::store_row(x + i * A::ROW, p.x);
  A::store_row(y + i * A::ROW, p.y);
  A::store_row(z + i * A::ROW, p.z);
}

// out = p1 + p2 (FPG_ADD), p1 + (x2, y2) for an affine p2 that is not the
// identity (FPG_ADD_MIXED: z2 is not read), or 2 p1 (FPG_DOUBLE: p2 is not
// read), at lane `lane`.
template <class A, int OP>
FP_FN void lane_fpg_op(const int* x1, const int* y1, const int* z1, const int* x2,
                       const int* y2, const int* z2, int* ox, int* oy, int* oz, long lane) {
  const Pt<A> p = fpg_load<A>(x1, y1, z1, lane);
  if constexpr (OP == FPG_ADD) {
    const Pt<A> q = fpg_load<A>(x2, y2, z2, lane);
    fpg_store<A>(ox, oy, oz, lane, ec_add<A>(p, q));
  } else if constexpr (OP == FPG_ADD_MIXED) {
    const typename A::E qx = A::load_row(x2 + lane * A::ROW), qy = A::load_row(y2 + lane * A::ROW);
    fpg_store<A>(ox, oy, oz, lane, ec_add_mixed<A>(p, qx, qy));
  } else {
    fpg_store<A>(ox, oy, oz, lane, ec_double<A>(p));
  }
}

// The largest `v` of this warp's lanes, the same for every thread of the
// warp (on the CPU build a lane is a warp of its own).
FP_FN int warp_max(int v) {
#ifdef __CUDACC__
  return __reduce_max_sync(__activemask(), v);
#else
  return v;
#endif
}

// out[lane] = sum over t < count[lane] of P[idx[start[lane] + t]], the points
// (x, y, z) added in order onto the identity with the complete add: one
// chunk of a bucket run of `msm_fp`.  The loop runs to the longest count of
// the warp, so a warp never branches around a product: a step past a lane's
// count adds point 0 and the select keeps the sum.  A lane with count 0
// gives the identity.
template <class A>
FP_FN void lane_fpg_chunk(const int* x, const int* y, const int* z, const int* idx,
                          const int* start, const int* count, int* ox, int* oy, int* oz,
                          long lane) {
  Pt<A> acc = ec_identity<A>();
  const long pos = start[lane];
  const int n = count[lane];
  const int steps = warp_max(n);
  FP_NO_UNROLL
  for (int t = 0; t < steps; t++) {
    const bool live = t < n;
    const long src = live ? (long)idx[pos + t] : 0L;
    const Pt<A> q = fpg_load<A>(x, y, z, src);
    acc = ec_select<A>(live, ec_add<A>(acc, q), acc);
  }
  fpg_store<A>(ox, oy, oz, lane, acc);
}

// out[lane] = [s] B, s row `lane` of (N, nl) canonical 16-bit limbs, by the
// 2 nl 8-bit windows of a table of B's affine multiples: for w < 2 nl, with
// d the window's digit, acc = d ? acc + T[w 256 + d] : acc, the complete
// mixed add with row w 256 + d of the (2 nl 256, 48) coordinate arrays
// (tx, ty) (`_window_table`: row w 256 stands in for d = 0 and is never
// kept), then the select.  The add is skipped where no lane of the warp has
// a nonzero digit, which changes no lane's result.
template <class A>
FP_FN void lane_fpg_fixed_base(const int* tx, const int* ty, const int* scal, int* ox, int* oy,
                               int* oz, int nl, long lane) {
  Pt<A> acc = ec_identity<A>();
  FP_NO_UNROLL
  for (int w = 0; w < 2 * nl; w++) {
    const u32 limb = (u32)scal[lane * nl + w / 2];
    const u32 d = (limb >> (FB_WINDOW * (w & 1))) & ((1u << FB_WINDOW) - 1u);
    if (any_lane(d != 0)) {
      const long row = ((long)w << FB_WINDOW) + d;
      const typename A::E x2 = A::load_row(tx + row * A::ROW), y2 = A::load_row(ty + row * A::ROW);
      acc = ec_select<A>(d != 0, ec_add_mixed<A>(acc, x2, y2), acc);
    }
  }
  fpg_store<A>(ox, oy, oz, lane, acc);
}
