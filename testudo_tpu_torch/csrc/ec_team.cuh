// The LSB-first ladder of ec.cuh's `lane_ladder`, worked by a TEAM of
// threads per lane: the schedule, as a table, and the work of one rank.
//
// One ladder step (acc = bit ? acc + base : acc; base = 2 base) runs the
// complete add and the complete double of ec.cuh, whose products mostly do
// not depend on each other: the add's t0, t1, t2, m3, m4, m5 and the
// double's t0, t1, t2, txy are ten independent products, then a1..a6 and
// b1..b4 ten more.  One thread runs them one after the other (20 Fq
// products, 63 for G2, where every Fq2 product is three Fq products by
// Karatsuba); a team runs each round's products side by side.
//
// The step is written once, below (`team_step`), over the same formulas as
// ec_add / ec_double / fp2_mul / fp2_mul_b3 and in the same order, but on
// slot numbers instead of values: it records a program of Fq operations,
// each a product or a sum / difference of two slots.  `team_schedule` puts
// every operation in the first STAGE after its operands are ready (a stage
// holds products only or sums only), gives each value a slot of the lane's
// shared memory once the slot's last value has been read, and writes the
// table: per stage, its operations, one 32-bit word each (operand slots a
// and b, result slot, subtract, select).  Rank r of a team runs operation r
// of every stage (T at a time when a stage holds more than T, T = TEAM_T)
// and the team syncs after each; ranks without one multiply zeros into a
// dummy slot, so every thread runs the same code and reaches every sync.  A
// stage never
// writes a slot that another operation of it reads, so the ranks of a stage
// may run in any order: csrc/host_check.cpp runs them one after another on
// the CPU, from this table and these functions.
//
// The values are the same canonical Fq elements the one-thread ladder
// computes (every operation reduces strictly), so the result is equal limb
// for limb; only which thread computes which product changes.
#pragma once
#include "ec.cuh"

#define TEAM_MAX_OPS 400
#define TEAM_MAX_STAGES 48
#define TEAM_SLOT_BITS 10
#define TEAM_SLOT_MASK ((1u << TEAM_SLOT_BITS) - 1u)

// The schedule of one ladder step, handed to the kernel by value.
// op word: a | b << 10 | out << 20 | subtract << 30 | select << 31
// stage word: first op | count << 16 | products << 31
struct TeamTable {
  int nops, nstages, nslots, nfixed;
  u32 op[TEAM_MAX_OPS];
  u32 stage[TEAM_MAX_STAGES];
};

// Fixed slots of a lane, for a group of nc Fq components per coordinate:
// acc X, Y, Z (component-major, as the packed rows), then base X, Y, Z, then
// zero, the constant k of G2's b3 (fp2.cuh), and the dummy that idle ranks
// write.  Temporaries follow.
#define TEAM_ZERO_SLOT(nc) (6 * (nc))
#define TEAM_KB3_SLOT(nc) (6 * (nc) + 1)
#define TEAM_DUMMY_SLOT(nc) (6 * (nc) + 2)
#define TEAM_NFIXED(nc) (6 * (nc) + 3)
// Threads per lane: 16 for G1 (two lanes a warp, 10 products a round), 32
// for G2 (one lane a warp, 30 Fq products a round); each beat the half size
// on an H100 (PERF.md section 6).  A divisor of 32: a team never spans warps.
#define TEAM_T(nc) ((nc) == 1 ? 16 : 32)
static_assert(32 % TEAM_T(1) == 0 && 32 % TEAM_T(2) == 0, "a team must not span warps");
// zero times zero into the dummy slot
#define TEAM_DUMMY_OP(nc)                                                  \
  ((u32)TEAM_ZERO_SLOT(nc) | ((u32)TEAM_ZERO_SLOT(nc) << TEAM_SLOT_BITS) | \
   ((u32)TEAM_DUMMY_SLOT(nc) << (2 * TEAM_SLOT_BITS)))

// ---------------------------------------------------------------------------
// The work of one rank (device and host)
// ---------------------------------------------------------------------------

// A lane's slots in shared memory, word-major: word j of slot s at
// region[j * ns + s], so the ranks' loads of one word hit different banks.
FP_FN void team_slot_load(u32* r, const u32* region, int ns, int s) {
  FP_UNROLL
  for (int j = 0; j < FQN; j++) r[j] = region[j * ns + s];
}

FP_FN void team_slot_store(u32* region, int ns, int s, const u32* a) {
  FP_UNROLL
  for (int j = 0; j < FQN; j++) region[j * ns + s] = a[j];
}

// r = a + b, or a - b when `sub` (as a + (p - b), with p - b in [1, p] and
// p for b = 0: a + p - b < 2p takes one conditional subtraction).  The
// same code runs either way: only a select depends on `sub`.
FP_FN void team_add_or_sub(u32* r, const u32* a, const u32* b, bool sub) {
  u32 nb[FQN];
  u64 borrow = 0;
  FP_UNROLL
  for (int i = 0; i < FQN; i++) {
    u64 s = (u64)FQ_P[i] - b[i] - borrow;
    nb[i] = sub ? (u32)s : b[i];
    borrow = s >> 63;
  }
  fp_add<Fq>(r, a, nb);
}

// One operation of a stage: a product when `mul` (the same for every rank
// of the stage), else a sum or difference; a `select` operation keeps the
// slot's old value unless the step's scalar bit is set.
FP_FN void team_op(u32* region, int ns, u32 op, bool mul, bool bit) {
  const int a = (int)(op & TEAM_SLOT_MASK);
  const int b = (int)((op >> TEAM_SLOT_BITS) & TEAM_SLOT_MASK);
  const int o = (int)((op >> (2 * TEAM_SLOT_BITS)) & TEAM_SLOT_MASK);
  u32 x[FQN], y[FQN];
  team_slot_load(x, region, ns, a);
  team_slot_load(y, region, ns, b);
  if (mul) {
    fp_mul_inline<Fq>(x, x, y);  // one product per thread and stage: inlined
  } else {
    u32 old[FQN];
    team_slot_load(old, region, ns, o);
    team_add_or_sub(x, x, y, ((op >> 30) & 1u) != 0);
    fp_select<Fq>(x, ((op >> 31) != 0) && !bit, old, x);
  }
  team_slot_store(region, ns, o, x);
}

// Operation i of the stage whose word is `stage`, or the dummy where the
// stage has no operation i (its last sub-round, or a rank it leaves idle).
FP_FN u32 team_pick(const u32* ops, u32 stage, int i, int nc) {
  const int count = (int)((stage >> 16) & 0x7fffu);
  return i < count ? ops[(stage & 0xffffu) + i] : TEAM_DUMMY_OP(nc);
}

// The rank's share of a lane's start: acc = identity, base = the lane's
// point, zero, k, dummy; component c goes to slot c.
template <class C>
FP_FN void team_init(u32* region, int ns, const int* pts, long L, long lane, int rank) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  for (int c = rank; c < TEAM_NFIXED(NC); c += TEAM_T(NC)) {
    u32 v[FQN];
    if (c < 3 * NC) {  // identity: (0, 1, 0), 1 in the first component of Y
      if (c == NC)
        fp_copy<Fq>(v, FQ_ONE);
      else
        fp_zero<Fq>(v);
    } else if (c < 6 * NC) {
      fp_load<Fq>(v, pts, L, lane, (c - 3 * NC) * 2 * FQN);
    } else if (c == TEAM_KB3_SLOT(NC)) {
      fp_copy<Fq>(v, FQ_B3K);
    } else {
      fp_zero<Fq>(v);
    }
    team_slot_store(region, ns, c, v);
  }
}

// The rank's share of a lane's end: acc's components to out.
template <class C>
FP_FN void team_store(int* out, const u32* region, int ns, long L, long lane, int rank) {
  constexpr int NC = C::COMP_ROWS / (2 * FQN);
  for (int c = rank; c < 3 * NC; c += TEAM_T(NC)) {
    u32 v[FQN];
    team_slot_load(v, region, ns, c);
    fp_store<Fq>(out, L, lane, c * 2 * FQN, v);
  }
}

// ---------------------------------------------------------------------------
// The program of one step and its schedule (host code: the launcher builds
// the table once per group)
// ---------------------------------------------------------------------------

// Values are numbered: 0 .. nfixed-1 are the fixed slots as the step finds
// them, nfixed + i the result of operation i.
struct TeamProg {
  int nfixed, n;
  int mul[TEAM_MAX_OPS], a[TEAM_MAX_OPS], b[TEAM_MAX_OPS], sub[TEAM_MAX_OPS];
  int out_fixed[TEAM_MAX_OPS], sel[TEAM_MAX_OPS];
  bool written[TEAM_MAX_OPS];  // per fixed slot: the step has stored to it
  bool bad;

  void init(int nf) {
    nfixed = nf;
    n = 0;
    bad = false;
    for (int i = 0; i < TEAM_MAX_OPS; i++) written[i] = false;
  }
  // a fixed slot is read only as the step found it, a selected value never
  bool readable(int v) const { return v < nfixed ? !written[v] : !sel[v - nfixed]; }
  int op(int is_mul, int x, int y, int is_sub) {
    if (n >= TEAM_MAX_OPS || !readable(x) || !readable(y)) {
      bad = true;
      return 0;
    }
    mul[n] = is_mul;
    a[n] = x;
    b[n] = y;
    sub[n] = is_sub;
    out_fixed[n] = -1;
    sel[n] = 0;
    return nfixed + n++;
  }
  int lin(int x, int y, int is_sub) { return op(0, x, y, is_sub); }
  int prod(int x, int y) { return op(1, x, y, 0); }
  // The operation that made v writes fixed slot f instead (with `select`:
  // only when the step's bit is set).  Nothing may read v afterwards.
  void store(int f, int v, bool select) {
    int i = v - nfixed;
    if (i < 0 || out_fixed[i] >= 0 || written[f] || (select && mul[i])) {
      bad = true;
      return;
    }
    out_fixed[i] = f;
    sel[i] = select;
    written[f] = true;
  }
};

// Coordinate policies of the recorder, as FqCoord / Fq2Coord are of ec.cuh.
struct TeamFq {
  typedef int E;
  static constexpr int NC = 1;
  static E at(int slot) { return slot; }
  static E add(TeamProg& p, E x, E y) { return p.lin(x, y, 0); }
  static E sub(TeamProg& p, E x, E y) { return p.lin(x, y, 1); }
  static E mul(TeamProg& p, E x, E y) { return p.prod(x, y); }
  static E mul3(TeamProg& p, E x) { return add(p, add(p, x, x), x); }  // fp_mul3
  static E mul_b3(TeamProg& p, E x) { return mul3(p, x); }
  static void store(TeamProg& p, int slot, E v, bool select) { p.store(slot, v, select); }
};

struct TeamFq2 {
  struct E {
    int c0, c1;
  };
  static constexpr int NC = 2;
  static E at(int slot) { return {slot, slot + 1}; }
  static E add(TeamProg& p, E x, E y) { return {p.lin(x.c0, y.c0, 0), p.lin(x.c1, y.c1, 0)}; }
  static E sub(TeamProg& p, E x, E y) { return {p.lin(x.c0, y.c0, 1), p.lin(x.c1, y.c1, 1)}; }
  static E mul(TeamProg& p, E x, E y) {  // fp2_mul
    int sa = p.lin(x.c0, x.c1, 0), sb = p.lin(y.c0, y.c1, 0);
    int t0 = p.prod(x.c0, y.c0), t1 = p.prod(x.c1, y.c1), s = p.prod(sa, sb);
    s = p.lin(s, t0, 1);
    int c1 = p.lin(s, t1, 1);
    s = p.lin(t1, t1, 0);
    s = p.lin(s, s, 0);
    s = p.lin(s, t1, 0);  // 5 t1
    return {p.lin(t0, s, 1), c1};
  }
  static E mul3(TeamProg& p, E x) { return {TeamFq::mul3(p, x.c0), TeamFq::mul3(p, x.c1)}; }
  static E mul_b3(TeamProg& p, E x) {  // fp2_mul_b3: (3 a1, k a0)
    int t = TeamFq::mul3(p, x.c1);
    return {t, p.prod(x.c0, TEAM_KB3_SLOT(NC))};
  }
  static void store(TeamProg& p, int slot, E v, bool select) {
    p.store(slot, v.c0, select);
    p.store(slot + 1, v.c1, select);
  }
};

// One ladder step: s = acc + base (ec_add), base = 2 base (ec_double),
// acc = bit ? s : acc, in ec.cuh's formulas and order.
template <class TC>
static void team_step(TeamProg& p) {
  typedef typename TC::E E;
  const int nc = TC::NC;
  const E px = TC::at(0), py = TC::at(nc), pz = TC::at(2 * nc);
  const E qx = TC::at(3 * nc), qy = TC::at(4 * nc), qz = TC::at(5 * nc);
  // ec_add(s, acc, base)
  E t0 = TC::mul(p, px, qx), t1 = TC::mul(p, py, qy), t2 = TC::mul(p, pz, qz);
  E t3 = TC::mul(p, TC::add(p, px, py), TC::add(p, qx, qy));  // m3
  E t4 = TC::mul(p, TC::add(p, py, pz), TC::add(p, qy, qz));  // m4
  E y3 = TC::mul(p, TC::add(p, px, pz), TC::add(p, qx, qz));  // m5
  t3 = TC::sub(p, t3, TC::add(p, t0, t1));
  t4 = TC::sub(p, t4, TC::add(p, t1, t2));
  y3 = TC::sub(p, y3, TC::add(p, t0, t2));
  // ec_add_tail
  E x3 = TC::add(p, t0, t0);
  t0 = TC::add(p, x3, t0);  // 3 X1X2
  E t2b = TC::mul_b3(p, t2), y3b = TC::mul_b3(p, y3);
  E z3 = TC::add(p, t1, t2b);
  t1 = TC::sub(p, t1, t2b);
  E sx = TC::sub(p, TC::mul(p, t3, t1), TC::mul(p, t4, y3b));   // a2 - a1
  E sy = TC::add(p, TC::mul(p, t1, z3), TC::mul(p, y3b, t0));   // a4 + a3
  E sz = TC::add(p, TC::mul(p, z3, t4), TC::mul(p, t0, t3));    // a6 + a5
  // ec_double(base, base)
  E d0 = TC::mul(p, qy, qy), d1 = TC::mul(p, qy, qz), d2 = TC::mul(p, qz, qz);
  E dxy = TC::mul(p, qx, qy);
  E dz3 = TC::add(p, d0, d0);
  dz3 = TC::add(p, dz3, dz3);
  dz3 = TC::add(p, dz3, dz3);  // 8 Y^2
  E d2b = TC::mul_b3(p, d2);
  E dy3 = TC::add(p, d0, d2b);
  d0 = TC::sub(p, d0, TC::mul3(p, d2b));
  E bz = TC::mul(p, d1, dz3);                                    // b2
  E by = TC::add(p, TC::mul(p, d2b, dz3), TC::mul(p, d0, dy3));  // b1 + b3
  E u = TC::mul(p, d0, dxy);                                     // b4
  E bx = TC::add(p, u, u);
  TC::store(p, 0, sx, true);
  TC::store(p, nc, sy, true);
  TC::store(p, 2 * nc, sz, true);
  TC::store(p, 3 * nc, bx, false);
  TC::store(p, 4 * nc, by, false);
  TC::store(p, 5 * nc, bz, false);
}

// dep[i][j]: operation i must run in a later stage than operation j (j < i):
// it reads j's value, or it writes a fixed slot whose value j reads.
static bool team_dep[TEAM_MAX_OPS][TEAM_MAX_OPS];
static bool team_feeds_product[TEAM_MAX_OPS];

static void team_dependencies(const TeamProg& p) {
  const int nf = p.nfixed, n = p.n;
  for (int i = 0; i < n; i++) {
    const int f = p.out_fixed[i];
    for (int j = 0; j < n; j++)
      team_dep[i][j] = j < i && (p.a[i] == nf + j || p.b[i] == nf + j ||
                                 (f >= 0 && (p.a[j] == f || p.b[j] == f)));
  }
  for (int j = 0; j < n; j++) {
    team_feeds_product[j] = false;
    for (int i = j + 1; i < n; i++)
      if (p.mul[i] && team_dep[i][j]) team_feeds_product[j] = true;
  }
}

// Put every operation that is ready at stage s (all it depends on in earlier
// stages) and of kind k into stage s; k < 0 takes sums while a ready sum
// feeds a product, else products.  Returns the kind placed, -1 if none.
static int team_fill(const TeamProg& p, int* stage, int s, int k, int* count) {
  static bool ready[TEAM_MAX_OPS];
  bool any[2] = {false, false}, urgent_sum = false;
  for (int i = 0; i < p.n; i++) {
    ready[i] = stage[i] < 0;
    for (int j = 0; j < i && ready[i]; j++)
      if (team_dep[i][j] && (stage[j] < 0 || stage[j] == s)) ready[i] = false;
    if (ready[i]) {
      any[p.mul[i]] = true;
      if (!p.mul[i] && team_feeds_product[i]) urgent_sum = true;
    }
  }
  if (k < 0) k = urgent_sum || !any[1] ? 0 : 1;
  if (!any[k]) return -1;
  *count = 0;
  for (int i = 0; i < p.n; i++)
    if (ready[i] && p.mul[i] == k) {
      stage[i] = s;
      ++*count;
    }
  return k;
}

// What the rest of a schedule costs from stage s on, filled by the rule of
// team_fill: a stage of products weighs 10, of sums 1, per 32 operations.
static int team_cost(const TeamProg& p, const int* stage0, int s) {
  static int stage[TEAM_MAX_OPS];
  for (int i = 0; i < p.n; i++) stage[i] = stage0[i];
  int cost = 0, count = 0, k;
  for (; (k = team_fill(p, stage, s, -1, &count)) >= 0 || (k = team_fill(p, stage, s, 1, &count)) >= 0; s++)
    cost += (k ? 10 : 1) * ((count + 31) / 32);
  return cost;
}

// Stages, slots and the table of the step's program; 0, or -1 if it does
// not fit the table.  Each stage takes the kind (products or sums) whose
// choice leaves the cheaper rest of the schedule (team_cost), and every
// ready operation of that kind.
static int team_schedule(const TeamProg& p, TeamTable& t) {
  const int nf = p.nfixed, n = p.n;
  static int stage[TEAM_MAX_OPS], trial[TEAM_MAX_OPS], last_use[TEAM_MAX_OPS];
  static int slot[TEAM_MAX_OPS], kind[TEAM_MAX_STAGES];
  team_dependencies(p);
  for (int i = 0; i < n; i++) stage[i] = -1;
  int nst = 0;
  for (int placed = 0; placed < n; nst++) {
    if (nst == TEAM_MAX_STAGES) return -1;
    int best = -1, best_cost = 0, count = 0;
    for (int k = 0; k < 2; k++) {
      for (int i = 0; i < n; i++) trial[i] = stage[i];
      if (team_fill(p, trial, nst, k, &count) < 0) continue;
      const int cost = (k ? 10 : 1) * ((count + 31) / 32) + team_cost(p, trial, nst + 1);
      if (best < 0 || cost < best_cost) {
        best = k;
        best_cost = cost;
      }
    }
    kind[nst] = team_fill(p, stage, nst, best, &count);
    placed += count;
  }
  for (int i = 0; i < n; i++) {
    last_use[i] = stage[i];
    for (int j = i + 1; j < n; j++)
      if ((p.a[j] == nf + i || p.b[j] == nf + i) && stage[j] > last_use[i]) last_use[i] = stage[j];
  }
  // slots: a temporary takes the lowest slot whose last value was last read
  // in an earlier stage
  static int busy_until[1 << TEAM_SLOT_BITS];
  for (int k = 0; k < (1 << TEAM_SLOT_BITS); k++) busy_until[k] = -1;
  int nslots = nf;
  for (int s = 0; s < nst; s++) {
    for (int i = 0; i < n; i++) {
      if (stage[i] != s) continue;
      if (p.out_fixed[i] >= 0) {
        slot[i] = p.out_fixed[i];
        continue;
      }
      int k = nf;
      while (k < (1 << TEAM_SLOT_BITS) && busy_until[k] >= s) k++;
      if (k >= (1 << TEAM_SLOT_BITS)) return -1;
      slot[i] = k;
      busy_until[k] = last_use[i];
      if (k + 1 > nslots) nslots = k + 1;
    }
  }
  // the table, stage by stage, operations in program order within a stage
  int m = 0;
  for (int s = 0; s < nst; s++) {
    const int first = m;
    for (int i = 0; i < n; i++) {
      if (stage[i] != s) continue;
      const int sa = p.a[i] < nf ? p.a[i] : slot[p.a[i] - nf];
      const int sb = p.b[i] < nf ? p.b[i] : slot[p.b[i] - nf];
      t.op[m++] = (u32)sa | ((u32)sb << TEAM_SLOT_BITS) | ((u32)slot[i] << (2 * TEAM_SLOT_BITS)) |
                  ((u32)p.sub[i] << 30) | ((u32)p.sel[i] << 31);
    }
    t.stage[s] = (u32)first | ((u32)(m - first) << 16) | ((u32)kind[s] << 31);
  }
  t.nops = n;
  t.nstages = nst;
  t.nslots = nslots;
  t.nfixed = nf;
  return 0;
}

// The table of one step for the group with nc components (1: G1, 2: G2);
// 0, or -1 if the program does not fit.
static int team_table(TeamTable& t, int nc) {
  static TeamProg p;  // large: kept off the stack
  p.init(TEAM_NFIXED(nc));
  if (nc == 1)
    team_step<TeamFq>(p);
  else if (nc == 2)
    team_step<TeamFq2>(p);
  else
    return -1;
  if (p.bad) return -1;
  return team_schedule(p, t);
}
