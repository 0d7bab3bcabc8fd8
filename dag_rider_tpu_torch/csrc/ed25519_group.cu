// Ed25519 group kernels for Hopper (sm_90a): the port of
// dag_rider_tpu/ops/pallas_group.py (_padd_xx_kernel, _finish_kernel,
// _pow22523_kernel) and dag_rider_tpu/ops/pallas_field.py (_mul_kernel).
// tree_sum_xyzt_kernel replaces the six _padd_xx_kernel launches of the
// comb tree (pallas_group.tree_sum_xyzt) with one.
//
// Field elements are 22 signed 12-bit limbs in int32 (radix 2^12), exactly
// as in ops/field.py: the same carry counts (2 after add/sub, 2 column
// passes + 3 final after a multiply), masks, arithmetic shifts and folds
// (TOP_FOLD, x19, (t & 7) << 9, 23104 at columns 44/45). The limbs out of
// every function here equal the torch and JAX twins' limbs bit for bit,
// and the reduced invariant (|limb0| < 2^14, |limb_i| < 2^13) keeps the sum
// of the absolute values of a product column's terms below 2^31, so a
// column summed in any order is exact in int32. Products are schoolbook in
// full (no symmetric squaring).
//
// What bounds these kernels: integer operations (int32 multiply-adds,
// shifts, masks). One 22x22 product is 484 IMADs plus ~600 carry/fold
// operations, a point addition 9 products.
//
// A quad an addition (padd_xx_kernel, the comb tree, the table kernels):
// four threads share each point operation, thread r computing row r of
// comb.padd_cached's two row-stacked products (quad_padd) or of
// comb.pdouble_packed's (quad_pdouble), the rows exchanged by shuffles
// inside the quad. padd_xx first ran a thread a lane with all 176 operand
// limbs in registers: 239 registers, 8 warps an SM, each lane a chain of
// ~10,700 dependent integer instructions; on an H100 (700 W) it took
// 0.48 ms at 262,144 lanes (5.8x its bytes bound), and at narrow widths
// one lane's latency set its time. The quad holds two rows a
// thread (at most 128 registers, QUAD_MIN_BLOCKS 4: 16 warps an SM), four
// times the threads for the same lanes and a third of the chain: 0.23 ms
// at 262,144 lanes, 0.007-0.008 ms up to 4,096. What bounds it is the
// SM's int32 rate: a quad issues ~1.5x the instructions of one thread a
// lane (row 2's 2d product is a branch the other three wait out, every
// thread forms both of its row's sums, and the shuffles), not its bytes
// (a lane's 264 ints are one read and one write, staged through the
// quad's 704 bytes of shared memory). A thread a lane with three field
// elements parked in shared memory instead of registers (128 registers,
// 16 warps) issued fewer instructions but hid less latency, and ran
// slower than the quad at every width. The grid is the blocks the card
// holds at once, each looping over lanes.
//
// field_mul_kernel: one thread per lane over limb-major [22, N] int32,
// every limb in registers, so device memory sees one read of each operand
// and one write of the result.
//
// The comb key tables (key_bases_kernel, key_entries_kernel,
// key_entries8_kernel) replace no pallas_call: the JAX package builds them
// as one jitted jnp scan (comb.build_key_tables, build_key_tables8), once
// a registry, and the port ran that scan as ~130,000 eager torch ops and
// 960 padd_xx launches (1.1-1.8 s a build on an H100). A build is now two
// launches (1.3 ms of kernels at n = 256): the window bases, a quad a key
// running the key's serial chain of 252 (4-bit) or 248 (8-bit) doublings
// in registers, which bounds the build (dependent products on a card that
// has little else to run: 32 to 128 warps at n = 256 to 1,024); then the
// entries straight into the gather's flat rows, a quad a (key, window)
// chain of 15 additions (4-bit) or a quad an item of each 8-bit window's
// 7 levels (evens double the previous level, odds add the base), 16
// windows a block with a barrier between levels. The same operation
// sequence as the plain build, so the same limbs.
//
// The finish tail (finish_kernel) and its square-root chain
// (pow22523_kernel) are ~287 and 262 dependent products per signature.
// They first ran one thread per signature in 32-thread blocks: 4,096
// signatures were 128 one-warp blocks, one warp on one of an SM's four
// schedulers, 255 registers, and each thread a chain of ~3 x 10^5
// dependent instructions; the kernel took one thread's latency and no
// occupancy hid it. Now a half-warp of G = 16 lanes shares each signature
// (wmul), two signatures a warp. Lane l holds limbs 2 l and 2 l + 1 (R = 2
// virtual lanes a lane); a product's 22 x 22 terms are split 22 to a limb
// position (column v and column 22 + v), the multiplier broadcast from
// shared memory and the multiplicand read from a doubled copy there; every
// carry, column pass and fold is a lane-parallel step with its carries
// moved by shuffles. 4,096 signatures are then 2,048 warps spread over
// every SM and all four schedulers. What bounds the design is the SM's
// int32 rate (64 lanes a clock, so each integer warp instruction holds a
// scheduler for two clocks): a warp issues ~180 integer instructions for
// its two products, against 484 useful multiply-adds each, because each
// term's multiply-add is issued for both of a limb position's columns
// under a predicate, and 5 lanes of a group hold no limb. A whole warp a
// signature (G = 32) was slower on the H100: a shuffle then serves one
// limb of one signature, and a multiplicand load one limb position. The
// five canonical forms of the tail (root1, root2, x's zero test and parity
// from one form, the two equality tests) stay sequential: every lane of
// the group runs canon22 on its own copy of the limbs, read from shared
// memory (the same instruction count as one lane, 5 of the tail's ~300
// field operations). finish_kernel reads the tree's [B, 2, 4, 22] output
// and r_y [B, 22] as they are, a lane its own limbs.

#include <cuda_runtime.h>

#define NL 22
#define LIMB_BITS 12
#define LIMB_MASK 0xFFF
#define TOP_FOLD 9728  // 19 << 9

// Limb constants of ops/field.py (tests/test_torch_field.py checks them).
#define D_LIMBS {2211, 1431, 2579, 1244, 1515, 2743, 472, 1044, 2637, 1792, 2048, \
                 3721, 1913, 1943, 1856, 2252, 3699, 1791, 3627, 1742, 515, 5}
#define D2_LIMBS {345, 2863, 1062, 2489, 3030, 1390, 945, 2088, 1178, 3585, 0, \
                  3347, 3827, 3886, 3712, 408, 3303, 3583, 3158, 3485, 1030, 2}
#define SQRT_M1_LIMBS {176, 234, 1866, 434, 1262, 1932, 4068, 2770, 2054, 1073, \
                       1839, 3450, 3579, 2451, 3328, 692, 3851, 3101, 79, 584, 2947, 2}
#define BIG_P_LIMBS {66797568, 67092480, 67092480, 67092480, 67092480, 67092480, \
                     67092480, 67092480, 67092480, 67092480, 67092480, 67092480, \
                     67092480, 67092480, 67092480, 67092480, 67092480, 67092480, \
                     67092480, 67092480, 67092480, 114688}

struct fe {
  int v[NL];
};

// ---------------------------------------------------------------------------
// Ring ops (field.carry / add / sub / neg)
// ---------------------------------------------------------------------------

template <int STEPS>
__device__ __forceinline__ fe carry2(fe x) {
#pragma unroll
  for (int s = 0; s < STEPS; s++) {
    int c[NL];
#pragma unroll
    for (int i = 0; i < NL; i++) {
      c[i] = x.v[i] >> LIMB_BITS;
      x.v[i] &= LIMB_MASK;
    }
    x.v[0] += c[NL - 1] * TOP_FOLD;
#pragma unroll
    for (int j = 0; j < NL - 1; j++) x.v[j + 1] += c[j];
  }
  return x;
}

__device__ __forceinline__ fe add22(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = a.v[i] + b.v[i];
  return carry2<2>(r);
}

__device__ __forceinline__ fe sub22(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = a.v[i] - b.v[i];
  return carry2<2>(r);
}

__device__ __forceinline__ fe dbl22(const fe& a) { return add22(a, a); }

// ---------------------------------------------------------------------------
// Multiply (field.mul): schoolbook columns, 2 column passes, the 2^255 == 19
// fold, 3 final carry steps.
// ---------------------------------------------------------------------------

__device__ __forceinline__ fe reduce_columns(int (&c)[46]) {
#pragma unroll
  for (int s = 0; s < 2; s++) {
    int cr[46];
#pragma unroll
    for (int k = 0; k < 46; k++) {
      cr[k] = c[k] >> LIMB_BITS;
      c[k] &= LIMB_MASK;
    }
#pragma unroll
    for (int k = 0; k < 45; k++) c[k + 1] += cr[k];
  }
  fe lo;
  int up[NL];
#pragma unroll
  for (int j = 0; j < NL; j++) {
    int t = c[NL + j] * 19;  // cols 22..43: weight 19 * 2^(12j + 9)
    lo.v[j] = c[j] + ((t & 0x7) << 9);
    up[j] = t >> 3;
  }
#pragma unroll
  for (int j = 0; j < NL - 1; j++) lo.v[j + 1] += up[j];
  int t2 = up[NL - 1] * 19;  // limb 22 (weight 2^264 == 19 * 2^9)
  lo.v[0] += (t2 & 0x7) << 9;
  lo.v[1] += t2 >> 3;
  lo.v[1] += c[44] * 23104;  // 2^528 == 361 * 2^18 (mod p)
  lo.v[2] += c[45] * 23104;  // 2^540 == 361 * 2^30 (mod p)
  return carry2<3>(lo);
}

__device__ __forceinline__ fe mul22(const fe& a, const fe& b) {
  int c[46];
#pragma unroll
  for (int k = 0; k < 46; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
#pragma unroll
    for (int j = 0; j < NL; j++) c[i + j] += a.v[i] * b.v[j];
  }
  return reduce_columns(c);
}

// Product with a constant limb vector; zero limbs are skipped (the caller
// passes a local array with a literal initializer, so after inlining every
// k[j] is a compile-time constant).
__device__ __forceinline__ fe mul22_const(const fe& a, const int (&k)[NL]) {
  int c[46];
#pragma unroll
  for (int n = 0; n < 46; n++) c[n] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
#pragma unroll
    for (int j = 0; j < NL; j++) {
      if (k[j] != 0) c[i + j] += a.v[i] * k[j];
    }
  }
  return reduce_columns(c);
}

// ---------------------------------------------------------------------------
// Canonical form and predicates (field._seq_carry_fold / canonical / ...)
// ---------------------------------------------------------------------------

__device__ __forceinline__ fe seq_carry_fold(const fe& x) {
  fe out;
  int carry_in = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    int v = x.v[i] + carry_in;
    out.v[i] = v & LIMB_MASK;
    carry_in = v >> LIMB_BITS;
  }
  out.v[0] += carry_in * TOP_FOLD;
  int hi = out.v[NL - 1] >> 3;  // bits 255..263, weight 2^255 == 19
  out.v[NL - 1] &= 0x7;
  out.v[0] += hi * 19;
  return out;
}

__device__ __forceinline__ fe canon22(fe x) {
  const int big_p[NL] = BIG_P_LIMBS;
#pragma unroll
  for (int i = 0; i < NL; i++) x.v[i] += big_p[i];
#pragma unroll
  for (int s = 0; s < 3; s++) x = seq_carry_fold(x);
  fe t;
  int carry_in = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    int v = x.v[i] + (i == 0 ? 19 : 0) + carry_in;
    t.v[i] = v & LIMB_MASK;
    carry_in = v >> LIMB_BITS;
  }
  bool ge_p = (t.v[NL - 1] >> 3) > 0;  // bit 255 set => x >= p
  t.v[NL - 1] &= 0x7;                  // == x - p
  return ge_p ? t : x;
}

// ---------------------------------------------------------------------------
// Group ops
// ---------------------------------------------------------------------------

__device__ __forceinline__ fe load_fe(const int* __restrict__ base, long long ld,
                                      int row0, long long lane) {
  fe x;
#pragma unroll
  for (int i = 0; i < NL; i++) x.v[i] = base[(row0 + i) * ld + lane];
  return x;
}

__device__ __forceinline__ void store_fe(int* __restrict__ base, long long ld,
                                         int row0, long long lane, const fe& x) {
#pragma unroll
  for (int i = 0; i < NL; i++) base[(row0 + i) * ld + lane] = x.v[i];
}

#define PACKED (4 * NL)  // ints per packed XYZT point

__device__ __forceinline__ fe load_row(const int* s) {
  fe x;
#pragma unroll
  for (int i = 0; i < NL; i++) x.v[i] = s[i];
  return x;
}

__device__ __forceinline__ void store_row(int* s, const fe& x) {
#pragma unroll
  for (int i = 0; i < NL; i++) s[i] = x.v[i];
}

// ---------------------------------------------------------------------------
// A point addition a quad: padd_xx and the comb tree
// ---------------------------------------------------------------------------

#define QUAD_THREADS 128   // 32 quads a block (padd_xx and the table kernels)
#define QUAD_MIN_BLOCKS 4  // blocks an SM holds: 16 warps, at most 128 registers
#define TREE_THREADS 128   // 32 quads of four threads, one addition per quad
#define TREE_GROUPS 2      // (signature, side) groups per block
#define TREE_MAX_M 64      // entries per group

// p + q by the four threads of a quad, in place (the sum overwrites p);
// p and q are packed XYZT points in shared memory. Thread r = 0..3 computes
// row r of the row-stacked products of comb.padd_cached(p, to_cached(q)):
// (Y1 - X1, Y1 + X1, T1, Z1) x (Y2 - X2, Y2 + X2, 2d T2, 2 Z2) = (A, B, C, D),
// then with E = B - A, F = D - C, G = D + C, H = B + A row r of
// (E F, G H, F G, E H). The quad's lanes are lane0 .. lane0 + 3 of the warp.
// Every thread forms carry(a +- b) of a pair of p's rows and a pair of q's
// (Y -+ X; Z + Z in row 3), used or not: the only branch is row 2's 2d
// product, which the other three threads wait out.
__device__ __forceinline__ void quad_padd(int* p, const int* q, int r, unsigned mask,
                                          int lane0) {
  const fe pa = load_row(p + (r < 2 ? 1 : (r == 2 ? 3 : 2)) * NL), pb = load_row(p);
  const fe qa = load_row(q + (r < 2 ? 1 : 2) * NL), qb = load_row(q + (r < 2 ? 0 : 2) * NL);
  fe ls, qs;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    ls.v[i] = pa.v[i] + (r == 0 ? -pb.v[i] : pb.v[i]);
    qs.v[i] = qa.v[i] + (r == 0 ? -qb.v[i] : qb.v[i]);
  }
  const fe lhs = r < 2 ? carry2<2>(ls) : pa;
  fe qc = carry2<2>(qs);
  if (r == 2) {
    const int d2[NL] = D2_LIMBS;
    qc = mul22_const(load_row(q + 3 * NL), d2);
  }
  const fe m = mul22(lhs, qc);
  __syncwarp(mask);  // the quad has read p and q before any row of p is overwritten
  fe u, v;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    const int a = __shfl_sync(mask, m.v[i], lane0);
    const int b = __shfl_sync(mask, m.v[i], lane0 + 1);
    const int c = __shfl_sync(mask, m.v[i], lane0 + 2);
    const int d = __shfl_sync(mask, m.v[i], lane0 + 3);
    u.v[i] = (r == 0 || r == 3) ? b - a : (r == 1 ? d + c : d - c);  // E, G, F, E
    v.v[i] = r == 0 ? d - c : (r == 2 ? d + c : b + a);              // F, H, G, H
  }
  const fe out = mul22(carry2<2>(u), carry2<2>(v));
#pragma unroll
  for (int i = 0; i < NL; i++) p[r * NL + i] = out.v[i];
}

// Replaces pallas_group._padd_xx_kernel: p + q for packed XYZT [88, n]
// operands (row r = coordinate * 22 + limb), a quad a lane on quad_padd:
// thread r stages row r of the lane's p and q in the quad's shared memory
// and writes row r of the sum. The grid is the blocks the card holds at
// once; lanes beyond it loop.
__global__ void __launch_bounds__(QUAD_THREADS, QUAD_MIN_BLOCKS)
padd_xx_kernel(const int* __restrict__ p, long long ldp, const int* __restrict__ q,
               long long ldq, int* __restrict__ out, long long ldo, long long n) {
  __shared__ int sm[QUAD_THREADS / 4][2 * PACKED];
  const int quad = threadIdx.x >> 2, r = threadIdx.x & 3, lane0 = threadIdx.x & 28;
  const unsigned mask = 0xFu << lane0;
  int* ps = sm[quad];
  int* qs = sm[quad] + PACKED;
  for (long long lane = (long long)blockIdx.x * (QUAD_THREADS / 4) + quad; lane < n;
       lane += (long long)gridDim.x * (QUAD_THREADS / 4)) {
#pragma unroll
    for (int i = 0; i < NL; i++) {
      ps[r * NL + i] = p[(r * NL + i) * ldp + lane];
      qs[r * NL + i] = q[(r * NL + i) * ldq + lane];
    }
    __syncwarp(mask);  // the quad's rows are staged
    quad_padd(ps, qs, r, mask, lane0);
#pragma unroll
    for (int i = 0; i < NL; i++) out[(r * NL + i) * ldo + lane] = ps[r * NL + i];
    __syncwarp(mask);  // every row is out before the next lane's come in
  }
}

// Replaces the 6 launches of pallas_group._padd_xx_kernel that the comb
// tree makes (comb.tree_sum_xyzt): sums the m entries of every group in
// shared memory, entry e + entry e + m/2, then m/4, down to 1 (the pairing
// of comb.tree_sum_packed). in: [groups, m, 88] contiguous, 16-byte
// aligned; out: [groups, 88]. m is a power of two, at most TREE_MAX_M.
__global__ void __launch_bounds__(TREE_THREADS, 4)
tree_sum_xyzt_kernel(const int* __restrict__ in, int* __restrict__ out, long long groups,
                     int m) {
  __shared__ int4 sm4[TREE_GROUPS * TREE_MAX_M * PACKED / 4];
  int* sm = reinterpret_cast<int*>(sm4);
  const long long g0 = (long long)blockIdx.x * TREE_GROUPS;
  const int ng = (int)(groups - g0 < TREE_GROUPS ? groups - g0 : TREE_GROUPS);
  const int per = m * PACKED;
  const int4* src = reinterpret_cast<const int4*>(in + g0 * per);
  for (int i = threadIdx.x; i < ng * per / 4; i += TREE_THREADS) sm4[i] = src[i];
  __syncthreads();
  const int quad = threadIdx.x >> 2, r = threadIdx.x & 3, lane0 = threadIdx.x & 28;
  const unsigned mask = 0xFu << lane0;
  for (int half = m >> 1; half > 0; half >>= 1) {
    for (int k = quad; k < ng * half; k += TREE_THREADS / 4) {
      int* g = sm + (k / half) * per;
      const int e = k % half;
      quad_padd(g + e * PACKED, g + (e + half) * PACKED, r, mask, lane0);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < ng * PACKED; i += TREE_THREADS)
    out[g0 * PACKED + i] = sm[(i / PACKED) * per + i % PACKED];
}

// ---------------------------------------------------------------------------
// The comb key tables: window bases, then entries
// ---------------------------------------------------------------------------

#define ENTRIES4 16      // entries of a 4-bit window
#define ENTRIES8 256     // entries of an 8-bit window
#define ENT8_WINDOWS 16  // 8-bit windows a block builds

// 2p by the four threads of a quad (comb.pdouble_packed): thread r holds
// row r (X, Y, Z, T) of p and returns row r of 2p. Thread r squares row r
// of (X, Y, Z, X + Y); the four squares (A, B, C, S) reach every thread by
// shuffles, and thread r multiplies row r of (E, G, F, E) by row r of (F,
// H, G, H). Every thread runs the same instructions (the choices are
// selects), so the rows are those of the plain doubling.
__device__ __forceinline__ fe quad_pdouble(const fe& row, int r, unsigned mask, int lane0) {
  fe xy;
#pragma unroll
  for (int i = 0; i < NL; i++)
    xy.v[i] = __shfl_sync(mask, row.v[i], lane0) + __shfl_sync(mask, row.v[i], lane0 + 1);
  xy = carry2<2>(xy);  // X + Y
  const fe sq = r == 3 ? xy : row;
  const fe m = mul22(sq, sq);
  fe a, b, c, s;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    a.v[i] = __shfl_sync(mask, m.v[i], lane0);
    b.v[i] = __shfl_sync(mask, m.v[i], lane0 + 1);
    c.v[i] = __shfl_sync(mask, m.v[i], lane0 + 2);
    s.v[i] = __shfl_sync(mask, m.v[i], lane0 + 3);
  }
  const fe h = add22(a, b), g = sub22(a, b);
  const fe e = sub22(h, s), f = add22(dbl22(c), g);
  const fe lhs = r == 1 ? g : (r == 2 ? f : e);
  const fe rhs = r == 0 ? f : (r == 2 ? g : h);
  return mul22(lhs, rhs);
}

// Replaces the window-base chain of comb.build_key_tables (four doublings
// a window) and build_key_tables8 (eight): bases[key, w] = 2^(dbl w) A_key
// for w < windows, packed XYZT rows [n, windows, 88]; A_key = (x, y, 1, t)
// from [n, 22] limbs. A quad a key, the chain of (windows - 1) dbl
// doublings in registers.
__global__ void __launch_bounds__(QUAD_THREADS)
key_bases_kernel(const int* __restrict__ ax, const int* __restrict__ ay,
                 const int* __restrict__ at, int* __restrict__ bases, long long n,
                 int windows, int dbl) {
  const long long key = (long long)blockIdx.x * (QUAD_THREADS / 4) + (threadIdx.x >> 2);
  if (key >= n) return;  // the whole quad
  const int r = threadIdx.x & 3, lane0 = threadIdx.x & 28;
  const unsigned mask = 0xFu << lane0;
  const int* src = r == 0 ? ax : (r == 1 ? ay : at);
  fe row;
#pragma unroll
  for (int i = 0; i < NL; i++) row.v[i] = r == 2 ? (i == 0) : src[key * NL + i];
  int* dst = bases + key * windows * PACKED + r * NL;
#pragma unroll 1
  for (int w = 0;; w++) {
    store_row(dst + w * PACKED, row);
    if (w + 1 == windows) break;
#pragma unroll 1
    for (int k = 0; k < dbl; k++) row = quad_pdouble(row, r, mask, lane0);
  }
}

// Copy a packed XYZT point row by row: thread r of a quad copies row r.
__device__ __forceinline__ void quad_copy(int* dst, const int* src, int r) {
  store_row(dst + r * NL, load_row(src + r * NL));
}

// Replaces the entry loop of comb.build_key_tables: window chain kw
// (key * 64 + window) gets TABLE[kw, 0] = the identity and TABLE[kw, d] =
// TABLE[kw, d - 1] + base into out [chains * 16, 88] (the gather's flat
// rows), a quad a chain on quad_padd: the running sum and the base stay
// in the quad's shared memory, thread r writes row r of each entry.
__global__ void __launch_bounds__(QUAD_THREADS, QUAD_MIN_BLOCKS)
key_entries_kernel(const int* __restrict__ bases, int* __restrict__ out, long long chains) {
  __shared__ int sm[QUAD_THREADS / 4][2 * PACKED];
  const int quad = threadIdx.x >> 2, r = threadIdx.x & 3, lane0 = threadIdx.x & 28;
  const unsigned mask = 0xFu << lane0;
  const long long kw = (long long)blockIdx.x * (QUAD_THREADS / 4) + quad;
  if (kw >= chains) return;  // the whole quad
  int* acc = sm[quad];
  int* b = sm[quad] + PACKED;
  int* e = out + kw * ENTRIES4 * PACKED + r * NL;
#pragma unroll
  for (int i = 0; i < NL; i++) acc[r * NL + i] = (i == 0) && (r == 1 || r == 2);  // (0, 1, 1, 0)
  quad_copy(b, bases + kw * PACKED, r);
  store_row(e, load_row(acc + r * NL));
#pragma unroll 1
  for (int d = 1; d < ENTRIES4; d++) {
    __syncwarp(mask);  // the quad's rows are in place
    quad_padd(acc, b, r, mask, lane0);
    store_row(e + d * PACKED, load_row(acc + r * NL));
  }
}

// Replaces the level loop of comb.build_key_tables8: each block builds
// ENT8_WINDOWS window tables of 256 entries in DIGIT_POS8 block order,
// position 0 the identity, 1 the base, then level by level (m = 1, 2, ...,
// 64): positions 2m + j = 2 (position m + j), then 3m + j = (position 2m +
// j) + base, j < m, a quad an item (quad_pdouble on rows in registers,
// quad_padd on rows staged in shared memory), a level's items spread over
// the block's quads. A level reads what other quads of the block wrote to
// out before the barrier.
__global__ void __launch_bounds__(QUAD_THREADS, QUAD_MIN_BLOCKS)
key_entries8_kernel(const int* __restrict__ bases, int* out, long long chains) {
  __shared__ int sm[QUAD_THREADS / 4][2 * PACKED];
  const int quad = threadIdx.x >> 2, r = threadIdx.x & 3, lane0 = threadIdx.x & 28;
  const unsigned mask = 0xFu << lane0;
  const long long kw0 = (long long)blockIdx.x * ENT8_WINDOWS;
  const int nw = (int)(chains - kw0 < ENT8_WINDOWS ? chains - kw0 : ENT8_WINDOWS);
  int* tab0 = out + kw0 * ENTRIES8 * PACKED;
  for (int k = threadIdx.x; k < nw * 2 * PACKED; k += QUAD_THREADS) {
    const int w = k / (2 * PACKED), i = k % (2 * PACKED);
    tab0[w * ENTRIES8 * PACKED + i] =
        i < PACKED ? (i == NL || i == 2 * NL) : bases[(kw0 + w) * PACKED + i - PACKED];
  }
  __syncthreads();
  int* ev = sm[quad];
  int* b = sm[quad] + PACKED;
#pragma unroll 1
  for (int m = 1; m < ENTRIES8 / 2; m <<= 1) {
    for (int it = quad; it < nw * m; it += QUAD_THREADS / 4) {
      int* tab = tab0 + (it / m) * ENTRIES8 * PACKED + r * NL;
      const int j = it % m;
      store_row(tab + (2 * m + j) * PACKED,
                quad_pdouble(load_row(tab + (m + j) * PACKED), r, mask, lane0));
    }
    __syncthreads();
    for (int it = quad; it < nw * m; it += QUAD_THREADS / 4) {
      const int w = it / m, j = it % m;
      int* tab = tab0 + w * ENTRIES8 * PACKED;
      quad_copy(ev, tab + (2 * m + j) * PACKED, r);
      quad_copy(b, bases + (kw0 + w) * PACKED, r);
      __syncwarp(mask);  // the quad's rows are staged
      quad_padd(ev, b, r, mask, lane0);
      quad_copy(tab + (3 * m + j) * PACKED, ev, r);
      __syncwarp(mask);  // every row is out before the next item's come in
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// A field element across a group of G = 16 lanes, a half-warp: two
// elements a warp. Lane l of the group holds R = 2 consecutive limbs,
// virtual lanes v = R l + r (r < R): limb v for v < 22. What virtual
// lanes 22 and up hold is of no use and is never masked: every shift moves
// values up (v - 1 to v), and the only values read downwards are limb 21's
// carry (into limb 0) and columns 44 and 45 (virtual lanes 22 and 23 of a
// product's upper columns, which the column passes keep exact), so nothing
// above limb 21 reaches limbs 0..21, and stores write limbs 0..21 only.
// Every lane of the warp calls these functions together (the group's
// choices are selects, not branches), so the shuffles and __syncwarp see
// the whole warp.
// ---------------------------------------------------------------------------

#define FULL_MASK 0xFFFFFFFFu
#define BB_STRIDE 45  // ints of a group's multiplicand copy: odd, so the two
                      // groups of a warp read other banks
constexpr int G = 16;      // lanes a group
constexpr int R = 32 / G;  // limbs (virtual lanes) a lane

struct W {
  int v[R];
};

// A group's scratch in shared memory.
struct GroupScratch {
  int* a;  // [24], 16-byte aligned: the multiplier (broadcast reads)
  int* b;  // [44]: the multiplicand, twice
  int* c;  // [24], 16-byte aligned: limbs of a canonical form
};

// y[v] = x[v - 1] across the group's virtual lanes, y[0] = 0.
__device__ __forceinline__ void vshift_up(const int (&x)[R], int (&y)[R], int l) {
  const int up = __shfl_up_sync(FULL_MASK, x[R - 1], 1, G);
  y[0] = l == 0 ? 0 : up;
#pragma unroll
  for (int r = 1; r < R; r++) y[r] = x[r - 1];
}

// y[v] = x[v - 1] across the group's virtual lanes, and y[0] = x[21]: the
// carry out of limb (or column) 21 wraps to the bottom in the same shuffle.
__device__ __forceinline__ void vrot_up(const int (&x)[R], int (&y)[R], int l) {
  y[0] = __shfl_sync(FULL_MASK, x[R - 1], l == 0 ? (NL - 1) / R : l - 1, G);
#pragma unroll
  for (int r = 1; r < R; r++) y[r] = x[r - 1];
}

// The value of virtual lane V (a compile-time constant), in every lane.
template <int V>
__device__ __forceinline__ int vget(const int (&x)[R]) {
  return __shfl_sync(FULL_MASK, x[V % R], V / R, G);
}

// field.carry: STEPS parallel carry steps, the carry out of limb 21 folded
// back into limb 0 as TOP_FOLD.
template <int STEPS>
__device__ __forceinline__ W wcarry(W x, int l) {
#pragma unroll
  for (int s = 0; s < STEPS; s++) {
    int c[R], up[R];
#pragma unroll
    for (int r = 0; r < R; r++) c[r] = x.v[r] >> LIMB_BITS;
    vrot_up(c, up, l);  // limb 0 takes the carry out of limb 21
#pragma unroll
    for (int r = 0; r < R; r++) x.v[r] = (x.v[r] & LIMB_MASK) + up[r];
    if (l == 0) x.v[0] += up[0] * (TOP_FOLD - 1);
  }
  return x;
}

__device__ __forceinline__ W wadd(const W& a, const W& b, int l) {
  W r;
#pragma unroll
  for (int k = 0; k < R; k++) r.v[k] = a.v[k] + b.v[k];
  return wcarry<2>(r, l);
}

__device__ __forceinline__ W wsub(const W& a, const W& b, int l) {
  W r;
#pragma unroll
  for (int k = 0; k < R; k++) r.v[k] = a.v[k] - b.v[k];
  return wcarry<2>(r, l);
}

__device__ __forceinline__ W wneg(const W& a, int l) {
  W r;
#pragma unroll
  for (int k = 0; k < R; k++) r.v[k] = -a.v[k];
  return wcarry<2>(r, l);
}

__device__ __forceinline__ W wsel(bool c, const W& a, const W& b) {
  W r;
#pragma unroll
  for (int k = 0; k < R; k++) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// Limb v of a row of 22 ints with the given stride (0 beyond limb 21).
__device__ __forceinline__ W wload(const int* __restrict__ row, long long stride, int l) {
  W x;
#pragma unroll
  for (int r = 0; r < R; r++) {
    const int v = R * l + r;
    x.v[r] = v < NL ? row[v * stride] : 0;
  }
  return x;
}

// field.mul across the group. Virtual lane v < 22 sums column v (terms
// i = 0..v) and column 22 + v (terms i = v + 1..21): 22 multiply-adds a
// virtual lane, every column once. The multiplier a comes as broadcast
// 16-byte loads; term i of virtual lane v takes b[(v - i) mod 22] from the
// doubled copy of b at index v - i + 22, one 4-byte load a term for a lane's
// R neighbouring columns (a sliding window: at R = 2 one load serves two
// virtual lanes). Then the two column passes, the x19 fold of columns
// 22..43 and the 23104 terms of columns 44, 45, and three carry steps, each
// a lane-parallel step with its carries moved by shuffles, as
// reduce_columns does them. int32 column sums are exact in any order under
// the reduced invariant, so the limbs equal mul22's.
__device__ __forceinline__ W wmul(const W& a, const W& b, const GroupScratch& s,
                                     int l) {
  __syncwarp();  // the group's previous product has finished reading s
#pragma unroll
  for (int r = 0; r < R; r++) {
    const int v = R * l + r;
    if (v < NL) {
      s.a[v] = a.v[r];
      s.b[v] = b.v[r];
      s.b[v + NL] = b.v[r];
    }
  }
  __syncwarp();
  int av[24];
#pragma unroll
  for (int g = 0; g < 6; g++) {
    const int4 q = reinterpret_cast<const int4*>(s.a)[g];
    av[4 * g] = q.x;
    av[4 * g + 1] = q.y;
    av[4 * g + 2] = q.z;
    av[4 * g + 3] = q.w;
  }
  int lo[R], hi[R];  // column v, column 22 + v
#pragma unroll
  for (int r = 0; r < R; r++) lo[r] = hi[r] = 0;
  if (R * l < NL) {
    const int* e = s.b + R * l + NL;  // b[(R l - i) mod 22] at e[-i]
    int w[R];
#pragma unroll
    for (int r = 0; r < R; r++) w[r] = e[r];
#pragma unroll
    for (int i = 0; i < NL; i++) {
      if (i > 0) {
#pragma unroll
        for (int r = R - 1; r > 0; r--) w[r] = w[r - 1];
        w[0] = e[-i];
      }
#pragma unroll
      for (int r = 0; r < R; r++) {
        const int p = av[i] * w[r];
        if (i <= R * l + r) lo[r] += p; else hi[r] += p;
      }
    }
  }
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {  // c = (c & MASK) + shift_up(c >> 12)
    int rl[R], rh[R], ul[R], uh[R];
#pragma unroll
    for (int r = 0; r < R; r++) {
      rl[r] = lo[r] >> LIMB_BITS;
      rh[r] = hi[r] >> LIMB_BITS;
    }
    vrot_up(rl, ul, l);  // column 22 (hi at v = 0) takes column 21's carry
    vrot_up(rh, uh, l);
#pragma unroll
    for (int r = 0; r < R; r++) {
      lo[r] = (lo[r] & LIMB_MASK) + ul[r];
      hi[r] = (hi[r] & LIMB_MASK) + uh[r];
    }
    if (l == 0) {  // column 0 takes no carry; column 22 takes column 21's
      lo[0] -= ul[0];
      hi[0] += ul[0] - uh[0];
    }
  }
  W x;
  int up[R], su[R];
#pragma unroll
  for (int r = 0; r < R; r++) {
    const int t = hi[r] * 19;  // cols 22..43: weight 19 * 2^(12v + 9)
    x.v[r] = lo[r] + ((t & 0x7) << 9);
    up[r] = t >> 3;
  }
  vshift_up(up, su, l);
  const int t2 = vget<NL - 1>(up) * 19;  // limb 22 (weight 2^264 == 19 * 2^9)
  const int c44 = vget<NL>(hi), c45 = vget<NL + 1>(hi);
#pragma unroll
  for (int r = 0; r < R; r++) {
    const int v = R * l + r;
    x.v[r] += su[r];
    if (v == 0) x.v[r] += (t2 & 0x7) << 9;
    if (v == 1) x.v[r] += (t2 >> 3) + c44 * 23104;  // 2^528 == 361 * 2^18
    if (v == 2) x.v[r] += c45 * 23104;              // 2^540 == 361 * 2^30
  }
  return wcarry<3>(x, l);
}

template <int N>
__device__ __forceinline__ W wnsq(W x, const GroupScratch& s, int l) {
#pragma unroll 1
  for (int i = 0; i < N; i++) x = wmul(x, x, s, l);
  return x;
}

// z^(2^252 - 3): pow22523's chain, the same 262 products in the same order.
__device__ __forceinline__ W wpow22523(const W& z, const GroupScratch& s, int l) {
  W t0 = wmul(z, z, s, l);                              // 2
  W t1 = wmul(z, wnsq<2>(t0, s, l), s, l);              // 9
  t0 = wmul(t0, t1, s, l);                                 // 11
  t0 = wmul(t1, wmul(t0, t0, s, l), s, l);                 // 31
  t0 = wmul(wnsq<5>(t0, s, l), t0, s, l);                  // 2^10 - 1
  t1 = wmul(wnsq<10>(t0, s, l), t0, s, l);                 // 2^20 - 1
  W t2 = wmul(wnsq<20>(t1, s, l), t1, s, l);            // 2^40 - 1
  t1 = wmul(wnsq<10>(t2, s, l), t0, s, l);                 // 2^50 - 1
  t2 = wmul(wnsq<50>(t1, s, l), t1, s, l);                 // 2^100 - 1
  W t3 = wmul(wnsq<100>(t2, s, l), t2, s, l);           // 2^200 - 1
  t1 = wmul(wnsq<50>(t3, s, l), t1, s, l);                 // 2^250 - 1
  return wmul(wnsq<2>(t1, s, l), z, s, l);                 // 2^252 - 3
}

// field.canonical of a group's element, in every lane of the group: the
// limbs go through the scratch, and each lane runs canon22's sequential
// passes on its own copy (the same instructions as one lane alone, and no
// broadcast of the result).
__device__ __forceinline__ fe wcanon(const W& x, const GroupScratch& s, int l) {
  __syncwarp();  // the previous canonical form has read s.c
#pragma unroll
  for (int r = 0; r < R; r++) {
    const int v = R * l + r;
    if (v < NL) s.c[v] = x.v[r];
  }
  __syncwarp();
  fe f;
#pragma unroll
  for (int g = 0; g < 6; g++) {
    const int4 q = reinterpret_cast<const int4*>(s.c)[g];
    const int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; i++)
      if (4 * g + i < NL) f.v[4 * g + i] = w[i];
  }
  return canon22(f);
}

__device__ __forceinline__ bool wis_zero(const W& x, const GroupScratch& s, int l) {
  const fe c = wcanon(x, s, l);
  bool z = true;
#pragma unroll
  for (int i = 0; i < NL; i++) z = z && (c.v[i] == 0);
  return z;
}

// D, SQRT_M1 and 2d as rows that lane v reads limb v of.
__device__ const int kFinishConst[3][NL] = {D_LIMBS, SQRT_M1_LIMBS, D2_LIMBS};

#define COOP_THREADS 128  // lanes of a block: 8 groups
// Blocks an SM must hold: 4,096 signatures are ~31 groups an SM, 496
// lanes, 4 blocks (128 registers a lane).
#define COOP_MIN_BLOCKS 4

// Replaces pallas_group._finish_kernel: R decompression (the square-root
// chain), rhs = R + [k]A and the projective equality [s]B == rhs, for
// signature j by the G lanes of group j. y: [n, 22]; sign: [n]; acc: [n,
// 176] (the tree's [n, 2, 4, 22]: [s]B's XYZT, then [k]A's); out[j] = 1 iff
// R is valid and [s]B == R + [k]A. The same decision tree as
// _finish_kernel, with both arms of every choice computed and selected.
__global__ void __launch_bounds__(COOP_THREADS, COOP_MIN_BLOCKS)
finish_kernel(const int* __restrict__ y_in, const int* __restrict__ sign_in,
              const int* __restrict__ acc, int* __restrict__ out, long long n) {
  __shared__ __align__(16) int sa[COOP_THREADS / G][24];
  __shared__ int sb[COOP_THREADS / G][BB_STRIDE];
  __shared__ __align__(16) int sc[COOP_THREADS / G][24];
  const int l = threadIdx.x % G, grp = threadIdx.x / G;
  const long long j = (long long)blockIdx.x * (COOP_THREADS / G) + grp;
  const long long jc = j < n ? j : n - 1;  // a group past n repeats the last signature
  const GroupScratch s{sa[grp], sb[grp], sc[grp]};

  const W y = wload(y_in + jc * NL, 1, l);
  const W d = wload(kFinishConst[0], 1, l);
  const W sqrt_m1 = wload(kFinishConst[1], 1, l);
  const W d2 = wload(kFinishConst[2], 1, l);
  const int sign = sign_in[jc];
  W one;
#pragma unroll
  for (int r = 0; r < R; r++) one.v[r] = (R * l + r) == 0;

  const W y2 = wmul(y, y, s, l);
  const W u = wsub(y2, one, l);
  const W v = wadd(wmul(y2, d, s, l), one, l);
  const W v3 = wmul(wmul(v, v, s, l), v, s, l);
  const W v7 = wmul(wmul(v3, v3, s, l), v, s, l);
  const W cand = wmul(wmul(u, v3, s, l), wpow22523(wmul(u, v7, s, l), s, l), s, l);
  const W vxx = wmul(v, wmul(cand, cand, s, l), s, l);
  const bool root1 = wis_zero(wsub(vxx, u, l), s, l);
  const bool root2 = wis_zero(wsub(vxx, wneg(u, l), l), s, l);
  W x = wsel(root1, cand, wmul(cand, sqrt_m1, s, l));
  bool valid = root1 || root2;
  const fe xc = wcanon(x, s, l);  // is_zero and parity from one canonical form
  bool x_zero = true;
#pragma unroll
  for (int i = 0; i < NL; i++) x_zero = x_zero && (xc.v[i] == 0);
  valid = valid && !(x_zero && sign == 1);
  x = wsel((xc.v[0] & 1) != sign, wneg(x, l), x);

  const long long row = jc * 2 * 4 * NL;
  const W kx = wload(acc + row + 4 * NL, 1, l);
  const W ky = wload(acc + row + 5 * NL, 1, l);
  const W kz = wload(acc + row + 6 * NL, 1, l);
  const W kt = wload(acc + row + 7 * NL, 1, l);
  // R + [k]A: to_cached and padd_core (add-2008-hwcd-3), R = (x, y, 1, xy)
  const W a = wmul(wsub(y, x, l), wsub(ky, kx, l), s, l);
  const W b = wmul(wadd(y, x, l), wadd(ky, kx, l), s, l);
  const W cc = wmul(wmul(x, y, s, l), wmul(kt, d2, s, l), s, l);
  const W dd = wmul(one, wadd(kz, kz, l), s, l);
  const W e = wsub(b, a, l), f = wsub(dd, cc, l), g = wadd(dd, cc, l), h = wadd(b, a, l);
  const W rx = wmul(e, f, s, l), ry = wmul(g, h, s, l), rz = wmul(f, g, s, l);

  const W lx = wload(acc + row, 1, l);
  const W ly = wload(acc + row + NL, 1, l);
  const W lz = wload(acc + row + 2 * NL, 1, l);
  const bool ex = wis_zero(wsub(wmul(lx, rz, s, l), wmul(rx, lz, s, l), l), s, l);
  const bool ey = wis_zero(wsub(wmul(ly, rz, s, l), wmul(ry, lz, s, l), l), s, l);
  if (l == 0 && j < n) out[j] = (ex && ey && valid) ? 1 : 0;
}

// Replaces pallas_group._pow22523_kernel: z^(2^252 - 3) for z [22, n]
// limb-major, lane j by the G lanes of group j, on wpow22523 (the chain
// the finish kernel runs).
__global__ void __launch_bounds__(COOP_THREADS, COOP_MIN_BLOCKS)
pow22523_kernel(const int* __restrict__ z, int* __restrict__ out, long long n) {
  __shared__ __align__(16) int sa[COOP_THREADS / G][24];
  __shared__ int sb[COOP_THREADS / G][BB_STRIDE];
  const int l = threadIdx.x % G, grp = threadIdx.x / G;
  const long long j = (long long)blockIdx.x * (COOP_THREADS / G) + grp;
  const long long jc = j < n ? j : n - 1;
  const GroupScratch s{sa[grp], sb[grp], nullptr};
  const W x = wpow22523(wload(z + jc, n, l), s, l);
  if (j < n) {
#pragma unroll
    for (int r = 0; r < R; r++) {
      const int v = R * l + r;
      if (v < NL) out[v * n + j] = x.v[r];
    }
  }
}

// Replaces pallas_field._mul_kernel: a * b, a and b [22, n].
__global__ void __launch_bounds__(128)
field_mul_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out, long long n) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_fe(out, n, 0, lane, mul22(load_fe(a, n, 0, lane), load_fe(b, n, 0, lane)));
}

// ---------------------------------------------------------------------------
// C interface: each launches on the given stream and returns
// cudaGetLastError() (0 on success). n == 0 launches nothing.
// ---------------------------------------------------------------------------

static inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// Blocks of padd_xx_kernel the current card holds at once (its SMs times
// the blocks an SM holds), looked up once a process.
static long long padd_resident_blocks() {
  static long long cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, padd_xx_kernel, QUAD_THREADS, 0);
    cached = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  return cached;
}

extern "C" int dr_padd_xx(const int* p, long long ldp, const int* q, long long ldq,
                          int* out, long long ldo, long long n, void* stream) {
  if (n > 0) {
    const long long need = blocks_for(n, QUAD_THREADS / 4), cap = padd_resident_blocks();
    padd_xx_kernel<<<(unsigned)(need < cap ? need : cap), QUAD_THREADS, 0,
                     (cudaStream_t)stream>>>(p, ldp, q, ldq, out, ldo, n);
  }
  return (int)cudaGetLastError();
}

// The comb key tables of n keys (x, y, t: [n, 22] limbs), in two launches:
// key_bases_kernel into bases [n, windows, 88] (scratch), then the entries
// into out, [n * 64 * 16, 88] (dr_key_tables) or [n * 32 * 256, 88]
// (dr_key_tables8).
static int key_bases(const int* x, const int* y, const int* t, int* bases, long long n,
                     int windows, int dbl, cudaStream_t s) {
  key_bases_kernel<<<blocks_for(n, QUAD_THREADS / 4), QUAD_THREADS, 0, s>>>(x, y, t, bases, n,
                                                                            windows, dbl);
  return (int)cudaGetLastError();
}

extern "C" int dr_key_tables(const int* x, const int* y, const int* t, int* bases, int* out,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = key_bases(x, y, t, bases, n, 64, 4, s);
  if (rc != 0) return rc;
  key_entries_kernel<<<blocks_for(n * 64, QUAD_THREADS / 4), QUAD_THREADS, 0, s>>>(bases, out,
                                                                                  n * 64);
  return (int)cudaGetLastError();
}

extern "C" int dr_key_tables8(const int* x, const int* y, const int* t, int* bases, int* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = key_bases(x, y, t, bases, n, 32, 8, s);
  if (rc != 0) return rc;
  key_entries8_kernel<<<blocks_for(n * 32, ENT8_WINDOWS), QUAD_THREADS, 0, s>>>(bases, out,
                                                                              n * 32);
  return (int)cudaGetLastError();
}

extern "C" int dr_tree_sum_xyzt(const int* in, int* out, long long groups, int m,
                                void* stream) {
  if (groups > 0)
    tree_sum_xyzt_kernel<<<blocks_for(groups, TREE_GROUPS), TREE_THREADS, 0,
                           (cudaStream_t)stream>>>(in, out, groups, m);
  return (int)cudaGetLastError();
}

extern "C" int dr_finish_check(const int* y, const int* sign, const int* acc, int* out,
                               long long n, void* stream) {
  if (n > 0)
    finish_kernel<<<blocks_for(n, COOP_THREADS / G), COOP_THREADS, 0, (cudaStream_t)stream>>>(
        y, sign, acc, out, n);
  return (int)cudaGetLastError();
}

extern "C" int dr_pow22523(const int* z, int* out, long long n, void* stream) {
  if (n > 0)
    pow22523_kernel<<<blocks_for(n, COOP_THREADS / G), COOP_THREADS, 0, (cudaStream_t)stream>>>(
        z, out, n);
  return (int)cudaGetLastError();
}

extern "C" int dr_field_mul(const int* a, const int* b, int* out, long long n,
                            void* stream) {
  if (n > 0)
    field_mul_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(a, b, out,
                                                                           n);
  return (int)cudaGetLastError();
}
