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
// and the reduced invariant (|limb0| < 2^14, |limb_i| < 2^13) keeps every
// product column below 2^31, so no operation overflows int32.
//
// Layout: limb-major [rows, N] int32, one thread per lane (batch element),
// for the per-lane kernels. The 32 threads of a warp read 32 neighbouring
// int32 of each row.
//
// What bounds these kernels: integer multiply-adds. One 22x22 product is
// 484 IMADs plus ~600 carry/fold operations, a point addition is 9
// products, the finish tail ~290, all dependent chains held per thread.
// The per-lane design keeps every limb in registers (arrays indexed only
// by compile-time constants under full unrolling) so device memory sees
// one read of each operand and one write of the result; the long squaring
// runs of the square-root chain are rolled loops (#pragma unroll 1) to
// keep code size sane. An addition keeps p, the cached q and 46 product
// columns live near the 255-register ceiling (ptxas -v reports registers
// and any spill per kernel).
//
// The comb tree sums the 64 gathered entries of every (signature, side)
// group: 63 additions in 6 levels. Run as 6 per-lane launches, every level
// went out to device memory and back, and a limb-major copy of the whole
// gather output came before the first. tree_sum_xyzt_kernel reads the
// gather's own [groups, 64, 88] output once into shared memory (22.5 KB a
// group, two groups a block) and runs all six levels there, writing one
// point per group. Each addition belongs to a quad of four threads: thread
// r computes row r of the row-stacked products of comb.padd_cached (the
// cached form of q, then (A, B, C, D), then (EF, GH, FG, EH)), with the
// rows exchanged by shuffles inside the quad. So a thread holds two
// operand rows and 46 columns instead of a whole addition, the critical
// path is three products instead of nine, and the deep levels (16, 8, ...,
// 1 additions a group) keep more threads busy than one thread per addition
// would. This does the earlier design's later work: shared memory and
// threads that cooperate on one addition.

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

__device__ __forceinline__ fe neg22(const fe& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < NL; i++) r.v[i] = -a.v[i];
  return carry2<2>(r);
}

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

template <int N>
__device__ __forceinline__ fe nsq(fe x) {
  if (N <= 4) {
#pragma unroll
    for (int i = 0; i < N; i++) x = mul22(x, x);
  } else {
#pragma unroll 1
    for (int i = 0; i < N; i++) x = mul22(x, x);
  }
  return x;
}

// z^(2^252 - 3): the RFC 8032 square-root exponent chain (field.pow22523).
__device__ __forceinline__ fe pow22523(const fe& z) {
  fe t0 = mul22(z, z);                    // 2
  fe t1 = mul22(z, nsq<2>(t0));           // 9
  t0 = mul22(t0, t1);                     // 11
  t0 = mul22(t1, mul22(t0, t0));          // 31
  t0 = mul22(nsq<5>(t0), t0);             // 2^10 - 1
  t1 = mul22(nsq<10>(t0), t0);            // 2^20 - 1
  fe t2 = mul22(nsq<20>(t1), t1);         // 2^40 - 1
  t1 = mul22(nsq<10>(t2), t0);            // 2^50 - 1
  t2 = mul22(nsq<50>(t1), t1);            // 2^100 - 1
  fe t3 = mul22(nsq<100>(t2), t2);        // 2^200 - 1
  t1 = mul22(nsq<50>(t3), t1);            // 2^250 - 1
  return mul22(nsq<2>(t1), z);            // 2^252 - 3
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

__device__ __forceinline__ bool is_zero22(const fe& x) {
  fe c = canon22(x);
  bool z = true;
#pragma unroll
  for (int i = 0; i < NL; i++) z = z && (c.v[i] == 0);
  return z;
}

__device__ __forceinline__ bool eq22(const fe& a, const fe& b) {
  return is_zero22(sub22(a, b));
}

__device__ __forceinline__ int parity22(const fe& x) { return canon22(x).v[0] & 1; }

// ---------------------------------------------------------------------------
// Group ops
// ---------------------------------------------------------------------------

// Packed XYZT -> cached (Y-X, Y+X, 2dT, 2Z), as comb.to_cached.
__device__ __forceinline__ void to_cached(const fe (&q)[4], fe (&qc)[4]) {
  const int d2[NL] = D2_LIMBS;
  qc[0] = sub22(q[1], q[0]);
  qc[1] = add22(q[1], q[0]);
  qc[2] = mul22_const(q[3], d2);
  qc[3] = dbl22(q[2]);
}

// add-2008-hwcd-3 with q in cached form, as comb.padd_cached.
__device__ __forceinline__ void padd_core(const fe (&p)[4], const fe (&qc)[4],
                                          fe (&r)[4]) {
  fe a = mul22(sub22(p[1], p[0]), qc[0]);
  fe b = mul22(add22(p[1], p[0]), qc[1]);
  fe cc = mul22(p[3], qc[2]);
  fe d = mul22(p[2], qc[3]);
  fe e = sub22(b, a);
  fe f = sub22(d, cc);
  fe g = add22(d, cc);
  fe h = add22(b, a);
  r[0] = mul22(e, f);
  r[1] = mul22(g, h);
  r[2] = mul22(f, g);
  r[3] = mul22(e, h);
}

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

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// Replaces pallas_group._padd_xx_kernel: p + q for packed XYZT [88, n]
// operands (row r = coordinate * 22 + limb), q cached in registers.
__global__ void __launch_bounds__(128)
padd_xx_kernel(const int* __restrict__ p, long long ldp, const int* __restrict__ q,
               long long ldq, int* __restrict__ out, long long ldo, long long n) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fe P[4], Q[4], QC[4], R[4];
#pragma unroll
  for (int c = 0; c < 4; c++) {
    P[c] = load_fe(p, ldp, c * NL, lane);
    Q[c] = load_fe(q, ldq, c * NL, lane);
  }
  to_cached(Q, QC);
  padd_core(P, QC, R);
#pragma unroll
  for (int c = 0; c < 4; c++) store_fe(out, ldo, c * NL, lane, R[c]);
}

// ---------------------------------------------------------------------------
// The comb tree in one launch
// ---------------------------------------------------------------------------

#define PACKED (4 * NL)   // ints per packed XYZT point
#define TREE_THREADS 128  // 32 quads of four threads, one addition per quad
#define TREE_GROUPS 2     // (signature, side) groups per block
#define TREE_MAX_M 64     // entries per group

__device__ __forceinline__ fe load_row(const int* s) {
  fe x;
#pragma unroll
  for (int i = 0; i < NL; i++) x.v[i] = s[i];
  return x;
}

// p + q by the four threads of a quad, in place (the sum overwrites p);
// p and q are packed XYZT points in shared memory. Thread r = 0..3 computes
// row r of the row-stacked products of comb.padd_cached(p, to_cached(q)):
// (Y1 - X1, Y1 + X1, T1, Z1) x (Y2 - X2, Y2 + X2, 2d T2, 2 Z2) = (A, B, C, D),
// then with E = B - A, F = D - C, G = D + C, H = B + A row r of
// (E F, G H, F G, E H). The quad's lanes are lane0 .. lane0 + 3 of the warp.
__device__ __forceinline__ void quad_padd(int* p, const int* q, int r, unsigned mask,
                                          int lane0) {
  fe lhs, qc;
  if (r == 2) {
    const int d2[NL] = D2_LIMBS;
    lhs = load_row(p + 3 * NL);
    qc = mul22_const(load_row(q + 3 * NL), d2);
  } else if (r == 3) {
    lhs = load_row(p + 2 * NL);
    qc = dbl22(load_row(q + 2 * NL));
  } else {
    const fe px = load_row(p), py = load_row(p + NL);
    const fe qx = load_row(q), qy = load_row(q + NL);
    lhs = r == 0 ? sub22(py, px) : add22(py, px);
    qc = r == 0 ? sub22(qy, qx) : add22(qy, qx);
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

// Replaces pallas_group._finish_kernel: R decompression (square-root
// chain), rhs = R + [k]A, and the projective equality [s]B == rhs.
// y [22, n]; sign [n]; acc [176, n] (rows 0..87 [s]B, 88..175 [k]A);
// out [n] = 1 iff R is valid and [s]B == R + [k]A.
__global__ void __launch_bounds__(32)
finish_kernel(const int* __restrict__ y_in, const int* __restrict__ sign_in,
              const int* __restrict__ acc, int* __restrict__ out, long long n) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int d[NL] = D_LIMBS;
  const int sqrt_m1[NL] = SQRT_M1_LIMBS;
  fe y = load_fe(y_in, n, 0, lane);
  int sign = sign_in[lane];
  fe one;
#pragma unroll
  for (int i = 0; i < NL; i++) one.v[i] = (i == 0);

  fe y2 = mul22(y, y);
  fe u = sub22(y2, one);
  fe v = add22(mul22_const(y2, d), one);
  fe v3 = mul22(mul22(v, v), v);
  fe v7 = mul22(mul22(v3, v3), v);
  fe cand = mul22(mul22(u, v3), pow22523(mul22(u, v7)));
  fe vxx = mul22(v, mul22(cand, cand));
  bool root1 = eq22(vxx, u);
  bool root2 = eq22(vxx, neg22(u));
  fe x = root1 ? cand : mul22_const(cand, sqrt_m1);
  bool valid = root1 || root2;
  bool x_zero = is_zero22(x);
  valid = valid && !(x_zero && sign == 1);
  bool flip = parity22(x) != sign;
  if (flip) x = neg22(x);

  fe rp[4] = {x, y, one, mul22(x, y)};
  fe ka[4], kc[4], rhs[4];
#pragma unroll
  for (int c = 0; c < 4; c++) ka[c] = load_fe(acc, n, 4 * NL + c * NL, lane);
  to_cached(ka, kc);
  padd_core(rp, kc, rhs);

  fe lhs[4];
#pragma unroll
  for (int c = 0; c < 4; c++) lhs[c] = load_fe(acc, n, c * NL, lane);
  bool ex = is_zero22(sub22(mul22(lhs[0], rhs[2]), mul22(rhs[0], lhs[2])));
  bool ey = is_zero22(sub22(mul22(lhs[1], rhs[2]), mul22(rhs[1], lhs[2])));
  out[lane] = (ex && ey && valid) ? 1 : 0;
}

// Replaces pallas_group._pow22523_kernel: z^(2^252 - 3), z [22, n].
__global__ void __launch_bounds__(32)
pow22523_kernel(const int* __restrict__ z, int* __restrict__ out, long long n) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  store_fe(out, n, 0, lane, pow22523(load_fe(z, n, 0, lane)));
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

extern "C" int dr_padd_xx(const int* p, long long ldp, const int* q, long long ldq,
                          int* out, long long ldo, long long n, void* stream) {
  if (n > 0)
    padd_xx_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
        p, ldp, q, ldq, out, ldo, n);
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
    finish_kernel<<<blocks_for(n, 32), 32, 0, (cudaStream_t)stream>>>(y, sign, acc,
                                                                      out, n);
  return (int)cudaGetLastError();
}

extern "C" int dr_pow22523(const int* z, int* out, long long n, void* stream) {
  if (n > 0)
    pow22523_kernel<<<blocks_for(n, 32), 32, 0, (cudaStream_t)stream>>>(z, out, n);
  return (int)cudaGetLastError();
}

extern "C" int dr_field_mul(const int* a, const int* b, int* out, long long n,
                            void* stream) {
  if (n > 0)
    field_mul_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(a, b, out,
                                                                           n);
  return (int)cudaGetLastError();
}
