// Prime-field arithmetic for the Hopper kernels: BLS12-377 Fq (and Fr for
// the stand-alone Montgomery kernel, BW6-761's 761-bit Fq for its row-major
// product and chain, BLS12-381's Fr for its row-major product, K1 and
// chain), one field element per thread.
//
// Replaces the in-kernel field layer of the TPU kernels
// (testudo_tpu/tpu/pallas_field.py:40-155 `_carry_ripple_rows`,
// `_cond_sub_p_rows`, `_mont_mul_rows*`; testudo_tpu/tpu/pallas_curve.py:149-250
// `_RowOpsFq`).  The TPU kept 16-bit limbs in 32-bit lanes, limb rows on
// sublanes and the batch on lanes, because it has no 64-bit multiply and a
// 1024-wide vector unit, and it deferred reductions (static `RV` bounds) to
// save vector ops.  Here a thread holds a whole element as N 32-bit words in
// registers (N = 12 for Fq, 8 for Fr) and runs a word-serial CIOS Montgomery
// product.  R is the same 2^(16 * nlimbs), so a Montgomery value is the same
// integer as in the JAX package; only the word size differs.  The functions
// here reduce strictly (every value canonical, < p); lazy.cuh keeps the
// TPU's static bounds for the one-thread group law over Fq and Fq2, on
// `fp_mul_lazy` below.
//
// In device memory a batch is `(rows, L)` int32, one 16-bit limb per row and
// the batch along L, so a warp's load of one limb row is coalesced;
// `fp_load` packs two limb rows into a word and `fp_store` splits them.
//
// The file also compiles as plain C++ (no CUDA): csrc/host_check.cpp runs
// the same functions on the CPU, where the tests hold them against the
// plain PyTorch versions.  fp2.cuh builds Fq2 on these functions, ec.cuh the
// group law of G1 and G2.
#pragma once
#include <stdint.h>

typedef uint32_t u32;
typedef uint64_t u64;

#ifdef __CUDACC__
#define FP_FN __device__ __forceinline__
#define FP_MUL_FN __device__ __noinline__
#define FP_CALL_FN static __device__ __noinline__
#define FP_MEMBER __device__ __forceinline__
#define FP_TABLE static __device__ __constant__ const
#define FP_CONSTEXPR __host__ __device__ constexpr
#define FP_UNROLL _Pragma("unroll")
#define FP_NO_UNROLL _Pragma("unroll 1")
#else
#define FP_FN static inline
#define FP_MUL_FN static inline
#define FP_CALL_FN static inline
#define FP_MEMBER inline
#define FP_TABLE static const
#define FP_CONSTEXPR constexpr
#define FP_UNROLL
#define FP_NO_UNROLL
#endif

// p, R mod p (the Montgomery form of 1) as little-endian 32-bit words.
// tests/test_torch_csrc.py checks these tables against fields/bls12_377.py.
FP_TABLE u32 FQ_P[12] = {
    0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u, 0xba094800u, 0x1ef3622fu,
    0x00f5138fu, 0x1a22d9f3u, 0x6ca1493bu, 0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};
FP_TABLE u32 FQ_ONE[12] = {
    0xffffff68u, 0x02cdffffu, 0x7fffffb1u, 0x51409f83u, 0x8a7d3ff2u, 0x9f7db3a9u,
    0x6e7c6305u, 0x7b4e97b7u, 0x803c84e8u, 0x4cf495bfu, 0xe2fdf49au, 0x008d6661u};
FP_TABLE u32 FR_P[8] = {
    0x00000001u, 0x0a118000u, 0xd0000001u, 0x59aa76feu,
    0x5c37b001u, 0x60b44d1eu, 0x9a2ca556u, 0x12ab655eu};
// BW6-761's base field q (fields/bw6_761.py), 761 bits in 24 words.
FP_TABLE u32 FQ761_P[24] = {
    0x0000008bu, 0xf49d0000u, 0x70000082u, 0xe6913e68u, 0xeaf0a437u, 0x160cf8aeu,
    0x5667a8f8u, 0x98a116c2u, 0x73ebff2eu, 0x71dcd3dcu, 0x12f9fd90u, 0x8689c8edu,
    0x25b42304u, 0x03cebaffu, 0xe584e919u, 0x707ba638u, 0x8087be41u, 0x528275efu,
    0x81d14688u, 0xb926186au, 0x04faff3eu, 0xd187c940u, 0xfb83ce0au, 0x0122e824u};
// R mod q = 2^768 mod q: the Montgomery form of 1 (the BW6 groups' identity
// has Y = 1).
FP_TABLE u32 FQ761_ONE[24] = {
    0xffff85d5u, 0x0202ffffu, 0x8fff8ce7u, 0x5a582635u, 0x827faadeu, 0x9e996e43u,
    0x0ee47df4u, 0xda6aff32u, 0x1d94b80bu, 0xece9cb3eu, 0x5248240bu, 0xc0e667a2u,
    0xdcad3905u, 0xa74da5bfu, 0x462f2103u, 0x2352e7feu, 0x08b1c87cu, 0x7b565880u,
    0xe711022fu, 0x45848a63u, 0x9f65a9dfu, 0xd7a81ebbu, 0xf127e87du, 0x0051f77eu};

// BLS12-381's scalar field r (fields/bls12_381.py), 255 bits in 8 words.
// R / r is about 2.2 (7.6 for BLS12-377's Fr): less room for the non-canonical
// operands below R that `_fold_wide` hands the product, which the CIOS body
// takes all the same (its running sum keeps a top word: `t_top`).
FP_TABLE u32 FR381_P[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};

// Field descriptors.  INV = -p^{-1} mod 2^32: the low word of the full-width
// N' the TPU kernel multiplies by (pallas_field.py:229).  Both BLS12-377
// moduli and BLS12-381's r are 1 mod 2^32, so their INV is all ones
// (tests/test_torch_bls12_381_kernel.py computes every INV from its table);
// q761's is not, and every body here reads F::INV.
struct FqParams {
  static constexpr int N = 12;
  static constexpr u32 INV = 0xffffffffu;
  FP_MEMBER static const u32* mod() { return FQ_P; }
};
struct FrParams {
  static constexpr int N = 8;
  static constexpr u32 INV = 0xffffffffu;
  FP_MEMBER static const u32* mod() { return FR_P; }
};
struct Fq761Params {
  static constexpr int N = 24;
  static constexpr u32 INV = 0x8fa798ddu;
  FP_MEMBER static const u32* mod() { return FQ761_P; }
};
struct Fr381Params {
  static constexpr int N = 8;
  static constexpr u32 INV = 0xffffffffu;
  FP_MEMBER static const u32* mod() { return FR381_P; }
};

// The field a Montgomery launcher (mont_mul.cu, mont_mul_rm.cu,
// mont_chain.cu) and its host body (host_check.cpp) runs in, named by the
// caller: device/packed_field.py derives it from the modulus, never from the
// limb count (BLS12-377's Fr and BLS12-381's Fr both have 16 limbs).  No id
// is a limb count, so a caller that passes one is refused.
enum FieldId {
  FIELD_FR = 1,      // BLS12-377 Fr, 16 limbs
  FIELD_FQ = 2,      // BLS12-377 Fq, 24 limbs
  FIELD_FQ761 = 3,   // BW6-761 Fq, 48 limbs
  FIELD_FR381 = 4,   // BLS12-381 Fr, 16 limbs
};

template <class F>
FP_FN void fp_copy(u32* r, const u32* a) {
  FP_UNROLL
  for (int i = 0; i < F::N; i++) r[i] = a[i];
}

template <class F>
FP_FN void fp_zero(u32* r) {
  FP_UNROLL
  for (int i = 0; i < F::N; i++) r[i] = 0;
}

// r = c ? a : b
template <class F>
FP_FN void fp_select(u32* r, bool c, const u32* a, const u32* b) {
  FP_UNROLL
  for (int i = 0; i < F::N; i++) r[i] = c ? a[i] : b[i];
}

// t (N words, plus `hi` above them) -> t - q when hi != 0 or t >= q: compute
// and select, no branch.  Callers guarantee the value is < 2q.
template <class F>
FP_FN void fp_cond_sub(u32* r, const u32* t, u32 hi, const u32* q) {
  constexpr int N = F::N;
  u32 d[N];
  u64 borrow = 0;
  FP_UNROLL
  for (int i = 0; i < N; i++) {
    u64 s = (u64)t[i] - q[i] - borrow;
    d[i] = (u32)s;
    borrow = s >> 63;
  }
  bool need = (hi != 0) | (borrow == 0);
  FP_UNROLL
  for (int i = 0; i < N; i++) r[i] = need ? d[i] : t[i];
}

// t (N words, plus `hi` above them) -> t - p when hi != 0 or t >= p.
// Callers guarantee the value is < 2p.
template <class F>
FP_FN void fp_cond_sub_p(u32* r, const u32* t, u32 hi) {
  fp_cond_sub<F>(r, t, hi, F::mod());
}

// r = a + b mod p.  Every modulus leaves spare top bits (377 of 384, 253 of
// 256, 761 of 768, 255 of 256), so a + b < 2p never carries out of N words.
template <class F>
FP_FN void fp_add(u32* r, const u32* a, const u32* b) {
  constexpr int N = F::N;
  u32 t[N];
  u64 c = 0;
  FP_UNROLL
  for (int i = 0; i < N; i++) {
    c += (u64)a[i] + b[i];
    t[i] = (u32)c;
    c >>= 32;
  }
  fp_cond_sub_p<F>(r, t, (u32)c);
}

// r = a - b mod p
template <class F>
FP_FN void fp_sub(u32* r, const u32* a, const u32* b) {
  constexpr int N = F::N;
  const u32* p = F::mod();
  u32 d[N];
  u64 borrow = 0;
  FP_UNROLL
  for (int i = 0; i < N; i++) {
    u64 s = (u64)a[i] - b[i] - borrow;
    d[i] = (u32)s;
    borrow = s >> 63;
  }
  u32 mask = 0u - (u32)borrow;  // all ones when a < b: add p back
  u64 c = 0;
  FP_UNROLL
  for (int i = 0; i < N; i++) {
    c += (u64)d[i] + (p[i] & mask);
    r[i] = (u32)c;
    c >>= 32;
  }
}

// r = 3a mod p (the curve constant b3 = 3b = 3 of G1)
template <class F>
FP_FN void fp_mul3(u32* r, const u32* a) {
  u32 t[F::N];
  fp_add<F>(t, a, a);
  fp_add<F>(r, t, a);
}

// (a * b + m p) / R for the m that makes it exact: coarsely integrated
// operand scanning (CIOS), word-serial.  Per word of b: t += a * b_i, then
// t = (t + m p) / 2^32 with m = t_0 * INV.  For operands below R the sum
// stays below a + p < 2R: N words in t plus the bit `t_top` (set only when
// a is near R: BLS12-381's Fr takes operands below R from `_fold_wide`).
// When a b < R p the result is below 2p; when one operand is also below p,
// one conditional subtract makes it canonical.  (u64)a*b + t + c <= 2^64 - 1,
// so nothing overflows.
template <class F>
FP_FN void fp_mont_rows(u32* t, u32& t_top, const u32* a, const u32* b) {
  constexpr int N = F::N;
  const u32* p = F::mod();
  FP_UNROLL
  for (int i = 0; i < N; i++) t[i] = 0;
  t_top = 0;
  FP_UNROLL
  for (int i = 0; i < N; i++) {
    u64 c = 0;
    u32 bi = b[i];
    FP_UNROLL
    for (int j = 0; j < N; j++) {
      u64 s = (u64)a[j] * bi + t[j] + c;
      t[j] = (u32)s;
      c = s >> 32;
    }
    u64 top = (u64)t_top + c;
    u32 m = t[0] * F::INV;
    u64 s = (u64)m * p[0] + t[0];
    c = s >> 32;
    FP_UNROLL
    for (int j = 1; j < N; j++) {
      s = (u64)m * p[j] + t[j] + c;
      t[j - 1] = (u32)s;
      c = s >> 32;
    }
    s = top + c;
    t[N - 1] = (u32)s;
    t_top = (u32)(s >> 32);
  }
}

// r = a * b * R^{-1} mod p, canonical: the CIOS rows and one conditional
// subtract.  r may alias a or b.
template <class F>
FP_FN void fp_mul_inline(u32* r, const u32* a, const u32* b) {
  u32 t[F::N], t_top;
  fp_mont_rows<F>(t, t_top, a, b);
  fp_cond_sub_p<F>(r, t, t_top);
}

// The product as a real call.  A G1 operation multiplies 8 to 12 times, a G2
// operation 25 to 38 times;
// with every product inlined a kernel's loop body grew to hundreds of KB,
// missed the instruction cache and ran 1.3x to 2.3x slower on an H100 (PERF.md).
// One shared copy keeps the body small; operands travel through local
// memory, which costs little beside ~300 multiply-adds.
// NOTE: never call this under a data-dependent `if` (threads of one warp
// taking different sides): `step` written that way returned wrong limbs on
// the H100.  Compute for every lane and select.
template <class F>
FP_MUL_FN void fp_mul(u32* r, const u32* a, const u32* b) {
  fp_mul_inline<F>(r, a, b);
}

// r = a * b * R^{-1} mod p, below 2p and not reduced further: the
// `lazy=True` product of pallas_field.py:86-94.  Only for a b < R p, where
// the CIOS sum's top bit is 0; lazy.cuh's choke point `lz_cap` is the one
// place that meets that cap, and only it reaches this.  A real call, as
// fp_mul, and the NOTE there holds.  r may alias a or b.
template <class F>
FP_MUL_FN void fp_mul_lazy(u32* r, const u32* a, const u32* b) {
  u32 t[F::N], t_top;
  fp_mont_rows<F>(t, t_top, a, b);
  FP_UNROLL
  for (int i = 0; i < F::N; i++) r[i] = t[i];
}

// Load element `lane` of a (rows, L) int32 array of 16-bit limbs whose
// first limb row is `row0`: word k = limb 2k | limb 2k+1 << 16.
template <class F>
FP_FN void fp_load(u32* r, const int* base, long L, long lane, int row0) {
  FP_UNROLL
  for (int k = 0; k < F::N; k++) {
    u32 lo = (u32)base[(long)(row0 + 2 * k) * L + lane];
    u32 hi = (u32)base[(long)(row0 + 2 * k + 1) * L + lane];
    r[k] = lo | (hi << 16);
  }
}

template <class F>
FP_FN void fp_store(int* base, long L, long lane, int row0, const u32* a) {
  FP_UNROLL
  for (int k = 0; k < F::N; k++) {
    base[(long)(row0 + 2 * k) * L + lane] = (int)(a[k] & 0xffffu);
    base[(long)(row0 + 2 * k + 1) * L + lane] = (int)(a[k] >> 16);
  }
}

// Load an element stored point-major: 2N consecutive int32 limbs at a
// 16-byte aligned address, read as 128-bit words (a thread's 96 bytes are
// contiguous even though neighbouring threads read unrelated rows).
struct alignas(16) Limb4 {
  int a, b, c, d;
};

template <class F>
FP_FN void fp_load_row(u32* r, const int* row) {
  const Limb4* q = reinterpret_cast<const Limb4*>(row);
  FP_UNROLL
  for (int k = 0; k < F::N / 2; k++) {
    Limb4 v = q[k];
    r[2 * k] = (u32)v.a | ((u32)v.b << 16);
    r[2 * k + 1] = (u32)v.c | ((u32)v.d << 16);
  }
}

template <class F>
FP_FN void fp_store_row(int* row, const u32* a) {
  Limb4* q = reinterpret_cast<Limb4*>(row);
  FP_UNROLL
  for (int k = 0; k < F::N / 2; k++) {
    Limb4 v;
    v.a = (int)(a[2 * k] & 0xffffu);
    v.b = (int)(a[2 * k] >> 16);
    v.c = (int)(a[2 * k + 1] & 0xffffu);
    v.d = (int)(a[2 * k + 1] >> 16);
    q[k] = v;
  }
}

// Per-lane body of the Montgomery kernel: the product of lane `lane` of two
// (2N, m) limb arrays.
template <class F>
FP_FN void lane_mont_mul(const int* a, const int* b, int* out, long m, long lane) {
  u32 x[F::N], y[F::N];
  fp_load<F>(x, a, m, lane, 0);
  fp_load<F>(y, b, m, lane, 0);
  fp_mul_inline<F>(x, x, y);  // one product per thread: nothing to share
  fp_store<F>(out, m, lane, 0, x);
}

// One product of the chained kernels, in the formulation asked for: the
// body inlined at the call site (as the Montgomery kernels run it) or the
// shared out-of-line copy (as the group-law kernels run it).
template <class F, bool INLINE>
FP_FN void fp_mul_as(u32* r, const u32* a, const u32* b) {
  if (INLINE)
    fp_mul_inline<F>(r, a, b);
  else
    fp_mul<F>(r, a, b);
}

// Per-lane body of the chained-product kernel: a <- a * b, K times, on lane
// `lane` of group `g` of (groups, 2N, L) limb-row arrays; operands are
// loaded once and the result stored once.
template <class F, bool INLINE>
FP_FN void lane_mont_chain(const int* a, const int* b, int* out, long L, long g, long lane,
                           int K) {
  const long off = g * (2 * F::N) * L;
  u32 x[F::N], y[F::N];
  fp_load<F>(x, a + off, L, lane, 0);
  fp_load<F>(y, b + off, L, lane, 0);
  FP_NO_UNROLL
  for (int k = 0; k < K; k++) fp_mul_as<F, INLINE>(x, x, y);
  fp_store<F>(out + off, L, lane, 0, x);
}

// The same chains with the G groups of one lane held by ONE thread: every
// step of the chain runs the G independent products one after the other.
template <class F, bool INLINE, int G>
FP_FN void lane_mont_chain_seq(const int* a, const int* b, int* out, long L, long lane, int K) {
  u32 x[G][F::N], y[G][F::N];
  FP_UNROLL
  for (int g = 0; g < G; g++) {
    fp_load<F>(x[g], a + (long)g * (2 * F::N) * L, L, lane, 0);
    fp_load<F>(y[g], b + (long)g * (2 * F::N) * L, L, lane, 0);
  }
  FP_NO_UNROLL
  for (int k = 0; k < K; k++) {
    FP_UNROLL
    for (int g = 0; g < G; g++) fp_mul_as<F, INLINE>(x[g], x[g], y[g]);
  }
  FP_UNROLL
  for (int g = 0; g < G; g++) fp_store<F>(out + (long)g * (2 * F::N) * L, L, lane, 0, x[g]);
}
