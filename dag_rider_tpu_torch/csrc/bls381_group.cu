// BLS12-381 G1 group kernel for Hopper (sm_90a): the port of
// dag_rider_tpu/ops/pallas_group381.py (_padd381_kernel), the addition under
// the G1 multi-scalar multiplication of threshold-coin and round-certificate
// aggregation (ops/bls_msm.py).
//
// Field elements are 33 signed 12-bit limbs in int32 (radix 2^12), exactly
// as in ops/field381.py: the same carry counts (2 after add/sub, 3 after
// mul_small and after the fold), masks, arithmetic shifts, and the same
// order of steps in a multiply (schoolbook into 67 columns, two
// column-normalize passes, the fold of columns 32..66 through FOLD, limb
// 32 = 0, three carry steps). The limbs out of every function here equal
// the torch and JAX twins' limbs bit for bit, and the reduced invariant
// (|limb| < 2^12 + 2^7) keeps every column below 2^29.4 in that order, so
// no operation overflows int32. Limbs are signed int: >> is arithmetic and
// & two's complement, as in torch and jnp.
//
// Layout: limb-major [99, N] int32 (row = coordinate * 33 + limb, X Y Z),
// one thread per lane. The 32 threads of a warp read 32 neighbouring int32
// of each row. Operands may be column slices of a wider tensor: each has
// its own row stride.
//
// What bounds this kernel: integer multiply-adds. One complete RCB15
// addition (a = 0, b3 = 12) is 12 general 33x33 products (1,089 IMADs of
// schoolbook and 1,117 of fold each, plus ~700 carry operations) and 2
// small multiplies, a dependent chain held per thread. A product alone
// holds 67 columns and 66 operand limbs, and the addition keeps p, q and
// up to eight temporaries (~550 limbs), far beyond 255 registers. So this
// first design keeps the points and temporaries in per-thread local
// memory (L1/L2-cached), and the product is one non-inlined device
// function whose operands and columns live in registers while it runs:
// it compiles once, which keeps nvcc fast, and every call reads 66 limbs
// and writes 33. FOLD sits in __constant__ memory: every lane reads the
// same entry at once, which the constant cache broadcasts. Shared-memory
// staging and a faster layout are later work.

#include <cuda_runtime.h>

#define NL 33
#define NCOLS 67
#define LIMB_BITS 12
#define LIMB_MASK 0xFFF

// FOLD[j] = the 32 strict limbs of 2^(12 (j + 32)) mod p (ops/field381.py;
// tests/test_torch_bls.py checks this table against it). Row 1 (2^396 mod
// p) is also the top-limb fold of the parallel carry step.
__constant__ int kFold[35][32] = {
    {4093, 47, 0, 0, 1545, 39, 3072, 3136, 11, 3904, 2795, 1419, 967, 1397, 2200, 1524,
     1861, 1317, 880, 1413, 1998, 1751, 1772, 2597, 2711, 113, 860, 3657, 2688, 3135, 1630, 351},  // 2^(12*32)
    {2943, 2060, 52, 0, 3971, 294, 1067, 3040, 3562, 4044, 1233, 3659, 3197, 1395, 1920, 1037,
     1477, 1664, 3782, 3353, 3491, 678, 1653, 628, 1654, 4070, 2970, 1519, 800, 3602, 1839, 151},  // 2^(12*33)
    {2234, 2697, 2062, 52, 466, 2298, 2344, 636, 892, 3179, 1351, 2798, 3154, 3776, 2950, 3549,
     1542, 3411, 1315, 1545, 3780, 823, 3753, 2957, 4000, 1811, 1727, 2234, 2947, 3829, 972, 396},  // 2^(12*34)
    {2796, 2553, 2702, 2062, 1904, 1145, 2302, 365, 1639, 3709, 2342, 2147, 2824, 2415, 1524, 2762,
     501, 365, 3956, 3404, 3238, 2267, 1558, 2907, 3812, 2736, 1754, 1366, 61, 1860, 521, 328},  // 2^(12*35)
    {1654, 3638, 2557, 2702, 2220, 3748, 3196, 736, 492, 1000, 895, 3947, 2977, 3199, 2020, 1620,
     4050, 460, 2276, 508, 1058, 589, 2582, 1225, 3510, 3, 2826, 3566, 2454, 3109, 1850, 113},  // 2^(12*36)
    {3724, 3509, 3639, 2557, 1770, 3007, 3749, 3033, 2195, 1260, 3634, 807, 1018, 107, 1610, 2647,
     3054, 3574, 3124, 1386, 2543, 1154, 3282, 1079, 1596, 1220, 151, 1664, 1117, 2156, 524, 368},  // 2^(12*37)
    {2888, 2571, 3514, 3639, 2085, 1242, 3011, 2515, 3675, 2708, 697, 1853, 2571, 2486, 2740, 2455,
     1226, 3800, 1698, 2835, 3237, 1931, 3513, 605, 2063, 3673, 3460, 2323, 3047, 2173, 720, 26},  // 2^(12*38)
    {2645, 162, 2572, 3514, 1336, 3210, 218, 2926, 2851, 923, 1994, 277, 3990, 144, 1603, 308,
     1905, 2893, 1631, 2459, 3920, 2279, 3847, 1225, 1124, 3033, 2290, 1398, 4013, 2475, 1409, 287},  // 2^(12*39)
    {1788, 1343, 166, 2572, 198, 1422, 3213, 539, 2527, 2596, 199, 1626, 1590, 3395, 2502, 1869,
     1740, 1727, 2347, 596, 965, 2227, 3980, 2183, 858, 3161, 1571, 491, 1167, 2170, 1988, 324},  // 2^(12*40)
    {1666, 2438, 1347, 166, 646, 1885, 3473, 1388, 619, 2656, 886, 221, 2683, 472, 2391, 596,
     3904, 525, 117, 1439, 2544, 3597, 3643, 1449, 132, 691, 3906, 1042, 3112, 3960, 3829, 174},  // 2^(12*41)
    {3522, 2657, 2440, 1347, 864, 4084, 3934, 160, 3640, 747, 1039, 2183, 3717, 3780, 2313, 1904,
     1752, 3390, 1024, 176, 2861, 3155, 1388, 907, 1449, 34, 1403, 3236, 3517, 955, 3319, 66},  // 2^(12*42)
    {3877, 2929, 2658, 2440, 3540, 3738, 3060, 3541, 1019, 1912, 52, 2276, 3167, 3315, 565, 3013,
     2616, 3718, 2117, 1789, 2695, 3743, 1470, 2585, 2248, 1554, 1376, 2139, 2917, 3044, 1217, 299},  // 2^(12*43)
    {3114, 3204, 2933, 2658, 266, 46, 1694, 362, 3297, 3708, 3712, 1913, 2163, 1777, 1299, 2616,
     3363, 1052, 1061, 1862, 554, 3941, 920, 3825, 2726, 1224, 446, 2471, 1663, 1226, 3003, 188},  // 2^(12*44)
    {3477, 729, 3207, 2933, 1955, 199, 3120, 376, 2790, 545, 3071, 1728, 3536, 3739, 3855, 3200,
     3020, 2131, 2468, 1838, 491, 2862, 3742, 281, 3539, 237, 2549, 1386, 223, 1486, 470, 415},  // 2^(12*45)
    {2734, 692, 735, 3207, 3947, 3448, 2251, 1796, 1622, 1639, 148, 439, 2632, 3001, 3270, 3771,
     391, 3129, 389, 996, 3871, 1042, 632, 3329, 2563, 1893, 1570, 4042, 1535, 2499, 477, 261},  // 2^(12*46)
    {1874, 56, 696, 735, 657, 2904, 1403, 1399, 1060, 2775, 2684, 42, 1328, 2943, 2357, 3524,
     2361, 676, 1923, 3898, 3655, 2485, 3816, 2332, 321, 4073, 353, 1427, 457, 4012, 3049, 241},  // 2^(12*47)
    {3303, 2273, 59, 696, 3626, 2873, 3930, 1793, 413, 3557, 462, 1122, 427, 2024, 1569, 2570,
     1296, 3814, 3998, 2746, 3743, 1053, 2688, 2276, 3673, 328, 2031, 420, 3583, 1923, 3632, 362},  // 2^(12*48)
    {1540, 1873, 2278, 59, 2220, 2870, 2877, 2777, 2367, 670, 493, 2767, 1847, 649, 3322, 2253,
     862, 2167, 2313, 1005, 2609, 2114, 3184, 2753, 3521, 87, 331, 3553, 1286, 2906, 2443, 193},  // 2^(12*49)
    {3461, 3507, 1875, 2278, 3500, 2362, 1848, 540, 1172, 2688, 2656, 1984, 4087, 2683, 809, 3797,
     1662, 3926, 85, 2436, 2100, 3335, 1811, 14, 1911, 273, 1903, 296, 3358, 1448, 1290, 364},  // 2^(12*50)
    {170, 2106, 3512, 1875, 744, 2806, 318, 1934, 1132, 3861, 1242, 3073, 3304, 1021, 1033, 2955,
     433, 1397, 1064, 656, 2676, 1375, 486, 3187, 2291, 322, 248, 922, 3980, 3462, 2229, 218},  // 2^(12*51)
    {3379, 3449, 2108, 3512, 2490, 1963, 3832, 433, 650, 301, 350, 579, 797, 1372, 2615, 853,
     1359, 4009, 2897, 2950, 3124, 3489, 3097, 2776, 3, 785, 1069, 1873, 495, 3834, 4095, 197},  // 2^(12*52)
    {2081, 1485, 3452, 2108, 853, 2826, 941, 3632, 2981, 2762, 937, 590, 257, 3003, 456, 76,
     2081, 851, 3501, 3102, 2892, 3766, 2749, 1703, 1082, 1862, 1343, 2530, 1170, 3699, 2453, 93},  // 2^(12*53)
    {3789, 2896, 1486, 3452, 469, 787, 1803, 1082, 740, 3814, 2161, 2858, 4008, 3976, 1525, 3550,
     3505, 3097, 825, 664, 2800, 3269, 3555, 2313, 2031, 3156, 3855, 2861, 3261, 2564, 1279, 184},  // 2^(12*54)
    {2126, 1175, 2899, 1486, 2194, 214, 2837, 3703, 3453, 1636, 3471, 1586, 314, 1640, 2824, 694,
     1433, 3716, 1672, 312, 3399, 1745, 519, 64, 905, 2185, 3102, 3706, 2785, 390, 1299, 198},  // 2^(12*55)
    {2080, 248, 1178, 2899, 3438, 2542, 216, 2317, 2159, 1406, 3205, 88, 222, 2986, 92, 3524,
     3907, 2729, 3501, 2348, 920, 1894, 231, 4087, 638, 1436, 3030, 1686, 3900, 2938, 2284, 144},  // 2^(12*56)
    {891, 1477, 250, 1178, 2786, 1472, 3568, 1465, 81, 1840, 3840, 2392, 3760, 1321, 2269, 1750,
     2005, 1040, 1289, 301, 1552, 3873, 420, 4045, 470, 1771, 3613, 3739, 2211, 4066, 2277, 45},  // 2^(12*57)
    {1216, 3280, 1477, 250, 1626, 650, 1473, 2240, 2051, 81, 387, 781, 938, 949, 1168, 3974,
     2017, 2504, 2535, 638, 105, 1811, 168, 1374, 215, 2943, 890, 1341, 3784, 2649, 136, 200},  // 2^(12*58)
    {709, 3525, 3282, 1477, 3755, 2048, 3724, 1871, 718, 2372, 104, 3782, 3063, 787, 4013, 2471,
     3421, 3982, 1221, 3150, 2290, 1453, 2734, 1815, 1154, 1416, 4047, 2286, 1152, 1668, 3983, 100},  // 2^(12*59)
    {1034, 1914, 3526, 3282, 1447, 4008, 1, 1546, 3171, 1358, 2604, 1252, 938, 3098, 318, 1268,
     3705, 560, 1540, 290, 1307, 945, 145, 1521, 1382, 3695, 3558, 2461, 1617, 3404, 3828, 12},  // 2^(12*60)
    {1323, 1711, 1914, 3526, 1873, 2003, 936, 119, 1712, 1827, 2583, 2157, 794, 1540, 924, 3627,
     2047, 3636, 3425, 3732, 2547, 1901, 2290, 2664, 645, 2531, 812, 1918, 810, 809, 1385, 140},  // 2^(12*61)
    {905, 496, 1713, 1914, 299, 3820, 980, 2566, 1924, 2288, 3501, 3337, 4045, 3565, 1477, 2294,
     2979, 2589, 2183, 1822, 1802, 2788, 3079, 2174, 47, 3978, 694, 839, 2183, 2727, 3460, 236},  // 2^(12*62)
    {3319, 1048, 499, 1713, 661, 2306, 750, 2391, 1517, 1349, 1448, 2559, 4024, 1385, 14, 3117,
     1061, 136, 1217, 3662, 3297, 781, 3095, 4070, 4071, 813, 1445, 1736, 942, 3310, 3207, 264},  // 2^(12*63)
    {1862, 833, 1052, 499, 1247, 3871, 260, 157, 1702, 1902, 1290, 2925, 3221, 1732, 1351, 2270,
     960, 2520, 2451, 2186, 2027, 726, 2453, 2897, 3717, 1939, 2714, 3642, 714, 3673, 2191, 281},  // 2^(12*64)
    {1807, 256, 837, 1052, 3782, 1082, 802, 2561, 3779, 2662, 3950, 122, 3573, 1969, 3808, 1519,
     2836, 3361, 494, 658, 324, 164, 759, 723, 375, 2304, 3223, 2328, 2765, 3588, 2414, 246},  // 2^(12*65)
    {3287, 2462, 259, 837, 3991, 2112, 2109, 172, 1638, 1156, 2974, 1767, 205, 3529, 2773, 2594,
     2392, 392, 3187, 663, 2969, 236, 262, 784, 1507, 3719, 752, 2315, 2441, 475, 2349, 236},  // 2^(12*66)
};

struct fe {
  int v[NL];
};

// ---------------------------------------------------------------------------
// Ring ops (field381.carry / add / sub / mul_small)
// ---------------------------------------------------------------------------

// One parallel carry step per iteration; the carry out of limb 32 (weight
// 2^396) folds back through row 1 of FOLD (field381._carry_step).
template <int STEPS>
__device__ __forceinline__ void carry33(int (&x)[NL]) {
#pragma unroll
  for (int s = 0; s < STEPS; s++) {
    int c[NL];
#pragma unroll
    for (int i = 0; i < NL; i++) {
      c[i] = x[i] >> LIMB_BITS;
      x[i] &= LIMB_MASK;
    }
#pragma unroll
    for (int j = 0; j < NL - 1; j++) x[j + 1] += c[j];
#pragma unroll
    for (int i = 0; i < NL - 1; i++) x[i] += c[NL - 1] * kFold[1][i];
  }
}

__device__ __forceinline__ void add33(const fe& a, const fe& b, fe& out) {
  int r[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = a.v[i] + b.v[i];
  carry33<2>(r);
#pragma unroll
  for (int i = 0; i < NL; i++) out.v[i] = r[i];
}

__device__ __forceinline__ void sub33(const fe& a, const fe& b, fe& out) {
  int r[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = a.v[i] - b.v[i];
  carry33<2>(r);
#pragma unroll
  for (int i = 0; i < NL; i++) out.v[i] = r[i];
}

__device__ __forceinline__ void mul_small33(fe& a, int k) {
  int r[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) r[i] = a.v[i] * k;
  carry33<3>(r);
#pragma unroll
  for (int i = 0; i < NL; i++) a.v[i] = r[i];
}

// ---------------------------------------------------------------------------
// Multiply (field381.mul): 33x33 schoolbook into 67 columns, two
// column-normalize passes, fold of columns 32..66 through FOLD, limb 32 = 0,
// three carry steps. Not inlined: one copy of the ~3,000-instruction body.
// ---------------------------------------------------------------------------

__device__ __noinline__ void mul33(const fe& a, const fe& b, fe& out) {
  int x[NL], y[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) {
    x[i] = a.v[i];
    y[i] = b.v[i];
  }
  int c[NCOLS];
#pragma unroll
  for (int k = 0; k < NCOLS; k++) c[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
#pragma unroll
    for (int j = 0; j < NL; j++) c[i + j] += x[i] * y[j];
  }
#pragma unroll
  for (int s = 0; s < 2; s++) {
    int cr[NCOLS];
#pragma unroll
    for (int k = 0; k < NCOLS; k++) {
      cr[k] = c[k] >> LIMB_BITS;
      c[k] &= LIMB_MASK;
    }
#pragma unroll
    for (int k = 0; k < NCOLS - 1; k++) c[k + 1] += cr[k];
  }
  int lo[NL];
#pragma unroll
  for (int i = 0; i < NL - 1; i++) lo[i] = c[i];
  lo[NL - 1] = 0;
#pragma unroll
  for (int j = 0; j < NCOLS - 32; j++) {
#pragma unroll
    for (int i = 0; i < 32; i++) lo[i] += c[32 + j] * kFold[j][i];
  }
  carry33<3>(lo);
#pragma unroll
  for (int i = 0; i < NL; i++) out.v[i] = lo[i];
}

// ---------------------------------------------------------------------------
// Complete addition, RCB15 Algorithm 7 (a = 0, b3 = 12): bls_msm.padd and
// pallas_group381._padd381_core, step for step.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void padd381(const fe (&p)[3], const fe (&q)[3], fe (&r)[3]) {
  fe t0, t1, t2, t3, t4, x3, y3, z3, u, v;
  mul33(p[0], q[0], t0);
  mul33(p[1], q[1], t1);
  mul33(p[2], q[2], t2);
  add33(p[0], p[1], u);
  add33(q[0], q[1], v);
  mul33(u, v, t3);
  add33(t0, t1, u);
  sub33(t3, u, t3);
  add33(p[1], p[2], u);
  add33(q[1], q[2], v);
  mul33(u, v, t4);
  add33(t1, t2, u);
  sub33(t4, u, t4);
  add33(p[0], p[2], u);
  add33(q[0], q[2], v);
  mul33(u, v, x3);
  add33(t0, t2, u);
  sub33(x3, u, y3);
  add33(t0, t0, u);
  add33(u, t0, x3);  // 3 X1 X2
  mul_small33(t2, 12);  // b3 Z1 Z2
  add33(t1, t2, z3);
  sub33(t1, t2, t1);
  mul_small33(y3, 12);  // b3 (X1 Z2 + X2 Z1)
  mul33(t3, t1, u);
  mul33(t4, y3, v);
  sub33(u, v, r[0]);
  mul33(y3, x3, u);
  mul33(t1, z3, v);
  add33(u, v, r[1]);
  mul33(z3, t4, u);
  mul33(x3, t3, v);
  add33(u, v, r[2]);
}

// ---------------------------------------------------------------------------
// Kernel
// ---------------------------------------------------------------------------

// Replaces pallas_group381._padd381_kernel: p + q for packed XYZ [99, n]
// operands with row strides ldp, ldq; out [99, n] with row stride ldo.
__global__ void __launch_bounds__(128)
padd381_kernel(const int* __restrict__ p, long long ldp, const int* __restrict__ q,
               long long ldq, int* __restrict__ out, long long ldo, long long n) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fe P[3], Q[3], R[3];
#pragma unroll
  for (int c = 0; c < 3; c++) {
#pragma unroll
    for (int i = 0; i < NL; i++) {
      P[c].v[i] = p[(c * NL + i) * ldp + lane];
      Q[c].v[i] = q[(c * NL + i) * ldq + lane];
    }
  }
  padd381(P, Q, R);
#pragma unroll
  for (int c = 0; c < 3; c++) {
#pragma unroll
    for (int i = 0; i < NL; i++) out[(c * NL + i) * ldo + lane] = R[c].v[i];
  }
}

// ---------------------------------------------------------------------------
// C interface: launches on the given stream and returns cudaGetLastError()
// (0 on success). n == 0 launches nothing.
// ---------------------------------------------------------------------------

extern "C" int dr_padd381_xx(const int* p, long long ldp, const int* q, long long ldq,
                             int* out, long long ldo, long long n, void* stream) {
  if (n > 0)
    padd381_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        p, ldp, q, ldq, out, ldo, n);
  return (int)cudaGetLastError();
}
