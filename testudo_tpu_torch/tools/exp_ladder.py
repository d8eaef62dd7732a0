"""The ladder's kernels at every width: where the team kernel stops paying,
and the wide kernel's forms.

The scalar-mul ladder has three kernels (device/packed_curve.py): the team
kernel (csrc/ladder_team.cu, a team of threads per lane), the wide kernel
(csrc/ladder_wide.cu: lanes in an order, each stopping after its top bit,
every lane a team of WIDE_T threads) and the one-thread kernel over all
bits (csrc/ladder.cu).  `PackedGroup.ladder` takes the team kernel up to
TEAM_LADDER_MAX_LANES lanes of its group; above, the wide kernel when its
lanes come longest first or number at most WIDE_LADDER_MAX_UNORDERED, else
the one-thread kernel; this harness measures the crossovers and the forms
behind those constants.  Run on a machine with the GPU:

    python3 -m testudo_tpu_torch.tools.exp_ladder [--forms] [--json]

For G1 and G2, at L = 20 ... 32,768 lanes and three kinds of scalars
(horner: lane l multiplies by 2^(13 (l mod 20)), as the MSM's Horner
combine, which passes no order; commit: 2^(8 (l mod 32)), as the sqrt-PST
commit's Horner, K columns of 32 windows, with the order
`_multi_horner_packed` passes: the lanes by bit length, longest first;
random: 253-bit scalars below r, as the MIPP folds and the small
multi-MSM, no order), it times the one-thread kernel, the team kernel and
the wide kernel, with CUDA events (mean of a few launches after a
warm-up), checks that all three give the same limbs, and prints one line
per width with the kernel the wrapper picks, and, for each kind given no
order, the widest width at which the team kernel still beats the wide
kernel.  With `--forms` it also builds, from one source that includes
csrc/ladder_wide.cu (into testudo_tpu_torch/_build/), the wide kernel at
other team sizes and block sizes and a form the library does not keep: a
launch split between teams (the first lanes of the order) and one thread
a lane (the rest, on blocks of their own), and a team on the masked add;
it times every form at 2,048 to 32,768 lanes (the commit's Horner at nv =
14 .. 20 and the NIZK prove's at 2^16) on commit and random scalars.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch

from ..curves import host_curve as hc
from ..device import build
from ..device import curve as tc
from ..device.field import FR
from ..device.packed_curve import G1P, G2P, TEAM_LADDER_MAX_LANES, WIDE_LADDER_MAX_UNORDERED
from ..fields.bls12_377 import R

WIDTHS = (20, 64, 256, 1024, 2048, 4096, 8192, 32768)
KINDS = ("horner", "commit", "random")
HORNER_C, HORNER_W = 13, 20
COMMIT_C, COMMIT_W = 8, 32
# the wide kernel's forms: (T, threads a block) per group, timed at these widths
FORMS = {1: tuple((t, b) for t in (2, 4, 8) for b in (32, 64, 128, 256)),
         2: tuple((t, b) for t in (4, 8, 16) for b in (32, 64, 128))}
# a team on the masked add at a set bit, then the doubling
MASKED_FORMS = {1: ((4, 32), (4, 128)), 2: ((4, 64), (8, 32))}
FORM_WIDTHS = (2048, 4096, 8192, 32768)

_CODE = r"""
#include "ladder_wide.cu"

#define EXP_FORM(C, T, TPB) \
  if (t == T && tpb == TPB) return ladder_wide_launch<C, T, TPB>(pts, scal, order, out, nl, L, st);

// The wide kernel at team size t and tpb threads a block; -1 for a form
// not built.
extern "C" int exp_wide(const int* pts, const int* scal, const int* order, int* out, int nl,
                        long L, int ncomp, int t, int tpb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1) {
    EXP_FORM(FqCoord, 2, 32) EXP_FORM(FqCoord, 2, 64) EXP_FORM(FqCoord, 2, 128)
    EXP_FORM(FqCoord, 2, 256) EXP_FORM(FqCoord, 4, 32) EXP_FORM(FqCoord, 4, 64)
    EXP_FORM(FqCoord, 4, 128) EXP_FORM(FqCoord, 4, 256) EXP_FORM(FqCoord, 8, 32)
    EXP_FORM(FqCoord, 8, 64) EXP_FORM(FqCoord, 8, 128) EXP_FORM(FqCoord, 8, 256)
  } else if (ncomp == 2) {
    EXP_FORM(Fq2Coord, 4, 32) EXP_FORM(Fq2Coord, 4, 64) EXP_FORM(Fq2Coord, 4, 128)
    EXP_FORM(Fq2Coord, 8, 32) EXP_FORM(Fq2Coord, 8, 64) EXP_FORM(Fq2Coord, 8, 128)
    EXP_FORM(Fq2Coord, 16, 32) EXP_FORM(Fq2Coord, 16, 64) EXP_FORM(Fq2Coord, 16, 128)
  }
  return -1;
}

// Position i of the split form's one-thread role: lane order[i] (or i) of
// ec.cuh's lane_ladder, stopping after its scalar's top bit while no lane
// of the warp has bits left, as the team body does.
template <class C>
__device__ void lane_one(const int* pts, const int* scal, const int* order, int* out, int nl,
                         long L, long i) {
  const long lane = order ? (long)order[i] : i;
  const int nb = scalar_bits(scal, nl, L, lane);
  Pt<C> acc, base, s;
  ec_set_identity<C>(acc);
  ec_load<C>(base, pts, L, lane);
  u32 limb = 0;
  FP_NO_UNROLL
  for (int b = 0; b < 16 * nl && any_lane(b < nb); b++) {
    if ((b & 15) == 0) limb = (u32)scal[(long)(b >> 4) * L + lane];
    const bool set = b < nb && ((limb >> (b & 15)) & 1u) != 0;
    if (any_lane(set)) {
      ec_add<C>(s, acc, base);
      ec_select<C>(acc, set, s, acc);
    }
    ec_double<C>(base, base);
  }
  ec_store<C>(out, L, lane, acc);
}

// The split form: positions 0 .. nteam - 1 of the order (nteam a multiple
// of the teams a block) as teams on the first blocks, the rest one thread
// a lane on the others.  The role is the block's, so no branch splits a
// warp.
template <class C, int T, int TPB>
__global__ void __launch_bounds__(TPB)
k_split(const int* pts, const int* scal, const int* order, int* out, int nl, long L, long nteam,
        WideTables tabs) {
  constexpr int TEAMS = TPB / T;
  const long team_blocks = nteam / TEAMS;
  if ((long)blockIdx.x >= team_blocks) {
    const long i = nteam + ((long)blockIdx.x - team_blocks) * TPB + threadIdx.x;
    if (i < L) lane_one<C>(pts, scal, order, out, nl, L, i);
    return;
  }
  extern __shared__ u32 smem[];
  const TeamTable& s = tabs.step;
  const TeamTable& d = tabs.dbl;
  u32* at = smem;
  for (int k = threadIdx.x; k < s.nops; k += TPB) at[k] = s.op[k];
  for (int k = threadIdx.x; k < s.nstages; k += TPB) at[s.nops + k] = s.stage[k];
  const TeamCode step = {at, at + s.nops, s.nstages};
  at += s.nops + s.nstages;
  for (int k = threadIdx.x; k < d.nops; k += TPB) at[k] = d.op[k];
  for (int k = threadIdx.x; k < d.nstages; k += TPB) at[d.nops + k] = d.stage[k];
  const TeamCode dbl = {at, at + d.nops, d.nstages};
  at += d.nops + d.nstages;
  __syncthreads();
  const int ns = s.nslots > d.nslots ? s.nslots : d.nslots;
  const int team = threadIdx.x / T;
  lane_ladder_wide_team<C, T>(at + team * ns * FQN, ns, step, dbl, pts, scal, order, out, nl, L,
                              (long)blockIdx.x * TEAMS + team, threadIdx.x % T);
}

template <class C, int T, int TPB>
static int split_launch(const int* pts, const int* scal, const int* order, int* out, int nl,
                        long L, long nteam, cudaStream_t st) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr int TEAMS = TPB / T;
  if (nteam < 0 || nteam > L || nteam % TEAMS) return -3;
  const TeamTable* s = team_table_once(NC, TEAM_LADDER_STEP);
  const TeamTable* d = team_table_once(NC, TEAM_LADDER_DOUBLE);
  if (!s || !d) return -2;
  const int ns = s->nslots > d->nslots ? s->nslots : d->nslots;
  const size_t smem = nteam == 0 ? 0
                                 : sizeof(u32) * ((size_t)s->nops + s->nstages + d->nops +
                                                  d->nstages + (size_t)TEAMS * ns * FQN);
  const int e = smem_opt_in(k_split<C, T, TPB>, smem);
  if (e) return e;
  const long grid = nteam / TEAMS + (L - nteam + TPB - 1) / TPB;
  const WideTables tabs = {*s, *d};
  k_split<C, T, TPB><<<(unsigned)grid, TPB, smem, st>>>(pts, scal, order, out, nl, L, nteam, tabs);
  return LAUNCH_STATUS();
}

#define EXP_SPLIT(C, T, TPB) \
  if (t == T && tpb == TPB) return split_launch<C, T, TPB>(pts, scal, order, out, nl, L, nteam, st);

// The split form at team size t and tpb threads a block; -1 for a form not
// built, -3 for nteam not a multiple of the teams a block.
extern "C" int exp_split(const int* pts, const int* scal, const int* order, int* out, int nl,
                         long L, long nteam, int ncomp, int t, int tpb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1) {
    EXP_SPLIT(FqCoord, 2, 32) EXP_SPLIT(FqCoord, 2, 64) EXP_SPLIT(FqCoord, 2, 128)
    EXP_SPLIT(FqCoord, 2, 256) EXP_SPLIT(FqCoord, 4, 32) EXP_SPLIT(FqCoord, 4, 64)
    EXP_SPLIT(FqCoord, 4, 128) EXP_SPLIT(FqCoord, 4, 256) EXP_SPLIT(FqCoord, 8, 32)
    EXP_SPLIT(FqCoord, 8, 64) EXP_SPLIT(FqCoord, 8, 128) EXP_SPLIT(FqCoord, 8, 256)
  } else if (ncomp == 2) {
    EXP_SPLIT(Fq2Coord, 4, 32) EXP_SPLIT(Fq2Coord, 4, 64) EXP_SPLIT(Fq2Coord, 4, 128)
    EXP_SPLIT(Fq2Coord, 8, 32) EXP_SPLIT(Fq2Coord, 8, 64) EXP_SPLIT(Fq2Coord, 8, 128)
    EXP_SPLIT(Fq2Coord, 16, 32) EXP_SPLIT(Fq2Coord, 16, 64) EXP_SPLIT(Fq2Coord, 16, 128)
  }
  return -1;
}

// The wide kernel's team with the masked add of fixed_base_team.cu in place
// of the ladder step's table, measured against the one in use: at a set bit the
// masked add (acc = bit ? acc + base : acc), then the doubling; else the
// doubling alone.  Its tables need a quarter fewer slots a lane (G1 25
// against 33), its set bits twice the rounds of products.  Every lane a
// team's.
template <class C, int T>
__device__ void lane_masked(u32* region, int ns, const TeamCode& add, const TeamCode& dbl,
                            const int* pts, const int* scal, const int* order, int* out, int nl,
                            long L, long i, int rank) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  constexpr int NF = TEAM_NFIXED(NC, PAIR_NPTS);
  const long pos = i < L ? i : L - 1;
  const long lane = order ? (long)order[pos] : pos;
  const int nb = scalar_bits(scal, nl, L, lane);
  team_identity<NC>(region, ns, 0, rank, T);
  team_load<NC>(region, ns, 1, pts, 1, L, lane, rank, T);
  team_consts(region, ns, NF, rank, T);
  TEAM_SYNC();
  u32 limb = 0;
  for (int b = 0; b < 16 * nl && team_any(b < nb); b++) {
    if ((b & 15) == 0) limb = (u32)scal[(long)(b >> 4) * L + lane];
    const bool set = b < nb && ((limb >> (b & 15)) & 1u) != 0;
    if (team_any(set)) team_run<T>(region, ns, add, TEAM_DUMMY_OP(NF), rank, set);
    team_run<T>(region, ns, dbl, TEAM_DUMMY_OP(NF), rank, false);
  }
  if (i < L) team_store<NC>(out, 1, L, lane, region, ns, 0, rank, T);
}

template <class C, int T, int TPB>
__global__ void __launch_bounds__(TPB)
k_masked(const int* pts, const int* scal, const int* order, int* out, int nl, long L,
         WideTables tabs) {
  extern __shared__ u32 smem[];
  const TeamTable& a = tabs.step;  // the masked add
  const TeamTable& d = tabs.dbl;
  u32* at = smem;
  for (int k = threadIdx.x; k < a.nops; k += TPB) at[k] = a.op[k];
  for (int k = threadIdx.x; k < a.nstages; k += TPB) at[a.nops + k] = a.stage[k];
  const TeamCode add = {at, at + a.nops, a.nstages};
  at += a.nops + a.nstages;
  for (int k = threadIdx.x; k < d.nops; k += TPB) at[k] = d.op[k];
  for (int k = threadIdx.x; k < d.nstages; k += TPB) at[d.nops + k] = d.stage[k];
  const TeamCode dbl = {at, at + d.nops, d.nstages};
  at += d.nops + d.nstages;
  __syncthreads();
  const int ns = a.nslots > d.nslots ? a.nslots : d.nslots;
  const int team = threadIdx.x / T;
  lane_masked<C, T>(at + team * ns * FQN, ns, add, dbl, pts, scal, order, out, nl, L,
                    (long)blockIdx.x * (TPB / T) + team, threadIdx.x % T);
}

template <class C, int T, int TPB>
static int masked_launch(const int* pts, const int* scal, const int* order, int* out, int nl,
                         long L, cudaStream_t st) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  const TeamTable* a = team_table_once(NC, TEAM_MASKED_ADD);
  const TeamTable* d = team_table_once(NC, TEAM_LADDER_DOUBLE);
  if (!a || !d) return -2;
  const int ns = a->nslots > d->nslots ? a->nslots : d->nslots;
  const size_t smem = sizeof(u32) * ((size_t)a->nops + a->nstages + d->nops + d->nstages +
                                     (size_t)(TPB / T) * ns * FQN);
  const int e = smem_opt_in(k_masked<C, T, TPB>, smem);
  if (e) return e;
  const WideTables tabs = {*a, *d};
  k_masked<C, T, TPB><<<(unsigned)((L + TPB / T - 1) / (TPB / T)), TPB, smem, st>>>(
      pts, scal, order, out, nl, L, tabs);
  return LAUNCH_STATUS();
}

#define EXP_MASKED(C, T, TPB) \
  if (t == T && tpb == TPB) return masked_launch<C, T, TPB>(pts, scal, order, out, nl, L, st);

// The masked-add team role, every lane a team's, at the forms below; -1 for
// another.
extern "C" int exp_masked(const int* pts, const int* scal, const int* order, int* out, int nl,
                          long L, int ncomp, int t, int tpb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (ncomp == 1) {
    EXP_MASKED(FqCoord, 4, 32) EXP_MASKED(FqCoord, 4, 128)
  } else if (ncomp == 2) {
    EXP_MASKED(Fq2Coord, 4, 64) EXP_MASKED(Fq2Coord, 8, 32)
  }
  return -1;
}

// What the kernel library uses for the group: T, threads a block.
extern "C" void exp_kept(int ncomp, int* out) {
  out[0] = WIDE_T(ncomp);
  out[1] = WIDE_TPB(ncomp);
}
"""


def scalars(kind: str, L: int, device) -> torch.Tensor:
    """(16, L) canonical scalar rows: "horner", "commit" or "random"."""
    if kind == "horner":
        ks = [1 << (HORNER_C * (l % HORNER_W)) for l in range(L)]
    elif kind == "commit":
        ks = [1 << (COMMIT_C * (l % COMMIT_W)) for l in range(L)]
    else:
        rng = np.random.default_rng(L)
        ks = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(L)]
    return torch.as_tensor(FR.to_limbs(ks).T.copy(), device=device)


def longest_first(scal: torch.Tensor) -> torch.Tensor:
    """The lanes by their scalars' bit length, longest first, equal lengths
    in lane order: the order `_multi_horner_packed` passes for its scalars."""
    ks = FR.from_limbs(scal.T.cpu().numpy())
    bits = np.array([-int(k).bit_length() for k in ks])
    return torch.as_tensor(np.argsort(bits, kind="stable").astype(np.int32), device=scal.device)


def points(Gp, L: int, device) -> torch.Tensor:
    """L distinct projective points: the generator times small scalars
    through the one-thread kernel."""
    gen = hc.g1_generator() if Gp is G1P else hc.g2_generator()
    lift = tc.g1_from_affine_host if Gp is G1P else tc.g2_from_affine_host
    g = Gp.pack(lift([gen], device=device)).repeat(1, L).contiguous()
    small = torch.zeros((1, L), dtype=torch.int32, device=device)
    small[0] = torch.arange(L, dtype=torch.int32, device=device) % 65521 + 3
    return Gp.ladder_launch("ladder", g, small)


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build_tool("exp_ladder", _CODE)))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.exp_wide.argtypes = [P, P, P, P, I, L, I, I, I, P]
    lib.exp_wide.restype = I
    lib.exp_split.argtypes = [P, P, P, P, I, L, L, I, I, I, P]
    lib.exp_split.restype = I
    lib.exp_masked.argtypes = [P, P, P, P, I, L, I, I, I, P]
    lib.exp_masked.restype = I
    lib.exp_kept.argtypes = [I, P]
    lib.exp_kept.restype = None
    return lib


def _ptr(t):
    return t.data_ptr() if t is not None else None


def wide_form(lib, Gp, pts, scal, order, T: int, tpb: int) -> torch.Tensor:
    out = torch.empty_like(pts)
    rc = lib.exp_wide(pts.data_ptr(), scal.data_ptr(), _ptr(order), out.data_ptr(),
                      scal.shape[0], pts.shape[1], Gp.ncomp, T, tpb,
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_wide (T = {T}, {tpb} threads a block) failed with {rc}")
    return out


def split_form(lib, Gp, pts, scal, order, nteam: int, T: int, tpb: int) -> torch.Tensor:
    out = torch.empty_like(pts)
    rc = lib.exp_split(pts.data_ptr(), scal.data_ptr(), _ptr(order), out.data_ptr(),
                       scal.shape[0], pts.shape[1], nteam, Gp.ncomp, T, tpb,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_split (T = {T}, {tpb} threads a block, {nteam} team lanes) "
                           f"failed with {rc}")
    return out


def masked_form(lib, Gp, pts, scal, order, T: int, tpb: int) -> torch.Tensor:
    out = torch.empty_like(pts)
    rc = lib.exp_masked(pts.data_ptr(), scal.data_ptr(), _ptr(order), out.data_ptr(), scal.shape[0], pts.shape[1], Gp.ncomp, T, tpb,
                        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exp_masked (T = {T}, {tpb} threads a block) failed with {rc}")
    return out


def _order_of(kind: str, scal: torch.Tensor):
    """The order the kind's caller passes: the commit's Horner its lanes
    longest first, the others none."""
    return longest_first(scal) if kind == "commit" else None


def in_use(Gp, pts, scal, order):
    """The kernel `PackedGroup.ladder` picks for these lanes, and a launch
    of it."""
    name = Gp.ladder_kernel(pts.shape[1], order is not None)
    if name == "ladder_wide":
        return name, lambda: Gp.ladder_wide_launch(pts, scal, order)
    return name, lambda: Gp.ladder_launch(name, pts, scal)


def run(device=torch.device("cuda"), widths=WIDTHS, say=print) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the harness times kernels: it needs a CUDA device")
    results = {}
    for Gp in (G1P, G2P):
        rows = []
        for L in widths:
            pts = points(Gp, L, device)
            row = {"L": L}
            for kind in KINDS:
                scal = scalars(kind, L, device)
                order = _order_of(kind, scal)
                launch = {
                    "one_thread": lambda: Gp.ladder_launch("ladder", pts, scal),
                    "team": lambda: Gp.ladder_launch("ladder_team", pts, scal),
                    "wide": lambda: Gp.ladder_wide_launch(pts, scal, order),
                }
                want = launch["one_thread"]()
                reps = 3 if L >= 8192 else 5
                row[kind] = {}
                for name, fn in launch.items():
                    if not torch.equal(fn(), want):
                        raise AssertionError(f"{Gp.name}: {name} differs at L={L} ({kind})")
                    row[kind][name] = _time_ms(fn, reps)
                row[kind]["in_use"] = in_use(Gp, pts, scal, order)[0]
            rows.append(row)
            say(f"{Gp.name} L={L:6d}: " + "; ".join(
                f"{kind} " + ", ".join(f"{k} {v:.4f}" for k, v in row[kind].items()
                                       if k != "in_use") +
                f" (in use: {row[kind]['in_use']})" for kind in KINDS) + " ms (all equal)")
        # per kind its callers hand the wrapper in no order: the widest width
        # up to which the team kernel beats the wide kernel
        best = {}
        for kind in ("horner", "random"):
            best[kind] = 0
            for row in rows:
                if row[kind]["team"] >= row[kind]["wide"]:
                    break
                best[kind] = row["L"]
        say(f"{Gp.name}: team kernel faster than the wide kernel up to L = {best['horner']} "
            f"on Horner scalars, {best['random']} on random ones (in use up to "
            f"{TEAM_LADDER_MAX_LANES[Gp.ncomp]} lanes; the wide kernel unordered up to "
            f"{WIDE_LADDER_MAX_UNORDERED[Gp.ncomp]})")
        results[Gp.name] = {"rows": rows, "team_faster_up_to": best}
    return results


def run_forms(device=torch.device("cuda"), widths=FORM_WIDTHS, reps: int = 5, say=print) -> dict:
    """Every form of the wide kernel on commit and random scalars, against
    the kernel in use and the one-thread kernel: every lane as a team, by
    the kernel ("teams=L") and by the split form with its one-thread role
    compiled in ("mixed"); no lane as a team ("teams=0", the split form's
    one-thread role alone, the team size moot); at the kept team size and
    block, the team lanes at a sixteenth to a half of the lanes; and a team
    on the masked add ("masked": at a set bit the masked add, then the
    doubling)."""
    device = torch.device(device)
    lib = _library()
    results = {}
    for Gp in (G1P, G2P):
        kept = (ctypes.c_int * 2)()
        lib.exp_kept(Gp.ncomp, kept)
        res = {"kept": {"T": kept[0], "tpb": kept[1]}}
        for L in widths:
            pts = points(Gp, L, device)
            for kind in ("commit", "random"):
                scal = scalars(kind, L, device)
                order = _order_of(kind, scal)
                want = Gp.ladder_launch("ladder", pts, scal)
                row = {"one_thread": _time_ms(lambda: Gp.ladder_launch("ladder", pts, scal), reps)}
                fns = {}
                for T, tpb in FORMS[Gp.ncomp]:
                    fns[f"T={T},tpb={tpb},teams=L"] = (
                        lambda T=T, tpb=tpb: wide_form(lib, Gp, pts, scal, order, T, tpb))
                    fns[f"T={T},tpb={tpb},mixed"] = (
                        lambda T=T, tpb=tpb: split_form(lib, Gp, pts, scal, order, L, T, tpb))
                    if T == kept[0]:
                        fns[f"tpb={tpb},teams=0"] = (
                            lambda T=T, tpb=tpb: split_form(lib, Gp, pts, scal, order, 0, T, tpb))
                for n in (L // 16, L // 8, L // 4, L // 2):
                    fns[f"T={kept[0]},tpb={kept[1]},teams={n}"] = (
                        lambda n=n: split_form(lib, Gp, pts, scal, order, n, kept[0], kept[1]))
                for T, tpb in MASKED_FORMS[Gp.ncomp]:
                    fns[f"T={T},tpb={tpb},masked"] = (
                        lambda T=T, tpb=tpb: masked_form(lib, Gp, pts, scal, order, T, tpb))
                for key, fn in fns.items():
                    if not torch.equal(fn(), want):
                        raise AssertionError(f"{Gp.name} L={L} {kind}: form {key} differs")
                    row[key] = _time_ms(fn, reps)
                forms = [k for k in row if k != "one_thread"]
                fastest = min(forms, key=lambda k: row[k])
                kernel, fn = in_use(Gp, pts, scal, order)
                in_use_ms = _time_ms(fn, reps)
                res[f"{L}_{kind}"] = {"ms": row, "fastest": fastest, "in_use_ms": in_use_ms,
                                      "in_use": kernel}
                say(f"{Gp.name} L={L} {kind}: fastest {fastest} {row[fastest]:.4f} ms, in use "
                    f"({kernel}) {in_use_ms:.4f}, one thread {row['one_thread']:.4f}; all: " +
                    ", ".join(f"{k} {v:.4f}" for k, v in row.items()) + " (all equal)")
        results[Gp.name] = res
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forms", action="store_true",
                    help="also time the wide kernel's team sizes, block sizes and a split form")
    ap.add_argument("--json", action="store_true", help="print the figures as one JSON line too")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exp_ladder: no CUDA device; the harness times kernels on the GPU", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    results = {"widths": run()}
    if args.forms:
        results["forms"] = run_forms()
    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
