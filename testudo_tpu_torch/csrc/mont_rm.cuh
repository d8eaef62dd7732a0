// The bodies of the row-major Montgomery kernels (mont_mul_rm.cu).
//
// The tiled form (long Fq arrays, and long arrays times a shared b: see
// mont_mul_rm.cu): a block stages a tile of RM_TPB rows, one element a
// thread, through shared memory, so that device memory is read and written
// in coalesced 16-byte words while each thread multiplies its own row.  A tile of one operand is RM_TPB * CH 16-byte
// chunks (CH = 4 for Fr, 6 for Fq: an element's 16 or 24 int32 limbs).
// Thread `tid` copies chunks tid, tid + RM_TPB, ... of the tile, so
// neighbouring threads move neighbouring words of device memory.  A chunk's
// place in shared memory is swizzled (`rm_slot`) so that when each thread
// reads its own row, the 8 threads of a quarter-warp (one 128-bit shared
// access) fall on 8 distinct 16-byte bank groups.
//
// The narrow form (every other array): one thread an element reading its
// row straight (`rm_lane`), one warp a block.
//
// The file also compiles as plain C++: csrc/host_check.cpp runs the same
// three phases (`rm_issue`, `rm_row_mul`, `rm_drain`) over a plain array
// with the threads as a loop, and the narrow body lane by lane;
// tests/test_torch_mont_mul_rm.py holds both against the plain PyTorch
// version.
#pragma once
#include "fp.cuh"

#define RM_TPB 128          // tiled form: threads a block, rows a tile
#define RM_NARROW_TPB 32    // narrow form: threads a block

template <class F>
struct Rm {
  static constexpr int CH = F::N / 2;         // 16-byte chunks a row
  static constexpr int TILE = RM_TPB * CH;    // chunks a tile of one operand
};

// Slot of chunk k of row r in a staged tile (16-byte units).  Fr: row r
// holds slots 4r .. 4r + 3 and its chunks are XORed with bits 1-2 of r;
// Fq: row r holds 6r .. 6r + 5 and its chunks are rotated by bit 2 of r.
// Either way rows r .. r + 7 (r a multiple of 8) reading their chunk k
// land on 8 distinct slots mod 8.
template <class F>
FP_FN int rm_slot(int r, int k) {
  if (Rm<F>::CH == 4) return 4 * r + (k ^ ((r >> 1) & 3));
  const int j = k + ((r >> 2) & 1);
  return 6 * r + (j == 6 ? 0 : j);
}

// One 16-byte copy from device to shared memory, asynchronous on the card
// (cp.async, bypassing L1); a plain copy on the CPU.
FP_FN void rm_copy16(Limb4* dst, const Limb4* src) {
#ifdef __CUDACC__
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

FP_FN void rm_commit() {
#ifdef __CUDACC__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until every copy group but the newest has landed (this thread's).
FP_FN void rm_wait_older() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// Chunks of tile `tile` that hold rows of the array (the last tile of n
// rows may be ragged).
template <class F>
FP_FN long rm_valid_chunks(long n, long tile) {
  const long rows = n - tile * RM_TPB;
  return (rows < RM_TPB ? rows : RM_TPB) * Rm<F>::CH;
}

// Phase 1: thread `tid` starts the copies of its chunks of tile `tile` of a
// (and of b unless `SHARED`) into the stage `st` (a's tile, then b's).
template <class F, bool SHARED>
FP_FN void rm_issue(Limb4* st, const int* a, const int* b, long n, long tile, int tid) {
  constexpr int CH = Rm<F>::CH;
  const long valid = rm_valid_chunks<F>(n, tile);
  const long first = tile * Rm<F>::TILE;
  const Limb4* ga = reinterpret_cast<const Limb4*>(a) + first;
  const Limb4* gb = reinterpret_cast<const Limb4*>(b) + (SHARED ? 0 : first);
  FP_UNROLL
  for (int j = 0; j < CH; j++) {
    const int c = tid + j * RM_TPB;
    if (c < valid) {
      const int s = rm_slot<F>(c / CH, c % CH);
      rm_copy16(st + s, ga + c);
      if (!SHARED) rm_copy16(st + Rm<F>::TILE + s, gb + c);
    }
  }
}

// Phase 2: thread `r` multiplies row r of the staged tile by row r of b's
// tile, or by `y` (SHARED), and writes the product over its a row.  Every
// thread runs it: rows past the end of the array hold stale limbs whose
// product is never stored.
template <class F, bool SHARED>
FP_FN void rm_row_mul(Limb4* st, const u32* y, int r) {
  constexpr int CH = Rm<F>::CH;
  u32 x[F::N], z[F::N];
  FP_UNROLL
  for (int k = 0; k < CH; k++) {
    const int s = rm_slot<F>(r, k);
    const Limb4 v = st[s];
    x[2 * k] = (u32)v.a | ((u32)v.b << 16);
    x[2 * k + 1] = (u32)v.c | ((u32)v.d << 16);
    if (!SHARED) {
      const Limb4 w = st[Rm<F>::TILE + s];
      z[2 * k] = (u32)w.a | ((u32)w.b << 16);
      z[2 * k + 1] = (u32)w.c | ((u32)w.d << 16);
    }
  }
  fp_mul_inline<F>(x, x, SHARED ? y : z);
  FP_UNROLL
  for (int k = 0; k < CH; k++) {
    Limb4 v;
    v.a = (int)(x[2 * k] & 0xffffu);
    v.b = (int)(x[2 * k] >> 16);
    v.c = (int)(x[2 * k + 1] & 0xffffu);
    v.d = (int)(x[2 * k + 1] >> 16);
    st[rm_slot<F>(r, k)] = v;
  }
}

// Phase 3: thread `tid` stores its chunks of the products of tile `tile`.
template <class F>
FP_FN void rm_drain(int* out, const Limb4* st, long n, long tile, int tid) {
  constexpr int CH = Rm<F>::CH;
  const long valid = rm_valid_chunks<F>(n, tile);
  Limb4* go = reinterpret_cast<Limb4*>(out) + tile * Rm<F>::TILE;
  FP_UNROLL
  for (int j = 0; j < CH; j++) {
    const int c = tid + j * RM_TPB;
    if (c < valid) go[c] = st[rm_slot<F>(c / CH, c % CH)];
  }
}

// The narrow form's body (k_mont_mul_rm_narrow): lane `lane` reads its own
// row straight from device memory.  A lane past the end computes the last
// row's product and stores nothing.
template <class F, bool SHARED>
FP_FN void rm_lane(const int* a, const int* b, int* out, long n, long lane) {
  const long row = lane < n ? lane : n - 1;
  u32 x[F::N], y[F::N];
  fp_load_row<F>(x, a + row * (2 * F::N));
  fp_load_row<F>(y, b + (SHARED ? 0 : row) * (2 * F::N));
  fp_mul_inline<F>(x, x, y);
  if (lane < n) fp_store_row<F>(out + lane * (2 * F::N), x);
}

// Shared-memory chunks of one stage (a's tile, and b's unless SHARED); a
// block holds two stages.
template <class F, bool SHARED>
struct RmStage {
  static constexpr int CHUNKS = (SHARED ? 1 : 2) * Rm<F>::TILE;
};
