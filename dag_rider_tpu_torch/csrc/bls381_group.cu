// BLS12-381 G1 group kernels for Hopper (sm_90a): the port of
// dag_rider_tpu/ops/pallas_group381.py (_padd381_kernel), the addition under
// the G1 multi-scalar multiplication of threshold-coin and round-certificate
// aggregation (ops/bls_msm.py), and of the jnp Horner combination and
// canonical form that follow it in dag_rider_tpu/ops/bls_msm.py
// (horner_combine, then field381.canonical in unpack_point).
//
// Field elements are 33 signed 12-bit limbs in int32 (radix 2^12), exactly
// as in ops/field381.py: the same carry counts (2 after add/sub, 3 after
// mul_small and after the fold), masks, arithmetic shifts, and the same
// steps in a multiply (schoolbook into 67 columns, two column-normalize
// passes, the fold of columns 32..66 through FOLD, limb 32 = 0, three carry
// steps). Every carry step of field381 is a parallel step (shift and mask
// each limb, add each carry to the next limb, fold the carry out of limb 32
// back through FOLD row 1), so it maps onto the lanes of a warp. The
// reduced invariant (|limb| < 2^12 + 2^7) bounds the sum of the absolute
// values of a column's terms below 2^29.4, so a column summed in any order
// is exact in int32: the limbs out of every function here equal the torch
// and JAX twins' limbs bit for bit. Limbs are signed int: >> is arithmetic
// and & two's complement, as in torch and jnp.
//
// Layout in device memory: limb-major [99, N] int32 (row = coordinate * 33
// + limb, X Y Z). Operands may be column slices of a wider tensor: each has
// its own row stride.
//
// What bounds these kernels. One complete RCB15 addition (a = 0, b3 = 12)
// is 12 general 33x33 products (1,089 schoolbook and 1,117 fold IMADs each,
// plus ~700 carry operations) and 2 small multiplies. On the MSM's path
// most additions form dependent chains: 15 table steps over T = 128-256
// lanes, log2 T tree levels, and the 320-step Horner chain on one point.
// So the time is set by the latency of one addition, not by the card's
// IMAD rate. The first design gave each lane one thread: a 33-limb product
// does not fit in registers, the operands went through a 2,520-byte
// local-memory stack with spills, and one addition was ~80 us of one
// thread's latency; the Horner chain was 320 launches of it.
//
// This design spreads one addition over a block of six warps (192
// threads), with the operands and temporaries staged in shared memory (one
// point is 396 B):
// - a field element lives across a warp: lane l holds limb l, and limb 32
//   is held by every lane; add, sub, mul_small and every carry step are
//   one instruction per lane plus two shuffles;
// - RCB15's two product stages each have six independent products
//   (t0, t1, t2, t3, t4, x3; then the products of X3, Y3 and Z3): warp w
//   computes product w of each stage, building its own operands from the
//   previous stage's results;
// - inside a product, lane l sums columns l and l + 32 (33 terms between
//   them), reading the multiplier as broadcast 16-byte loads and the
//   multiplicand from a doubled copy in shared memory at consecutive
//   addresses (no bank conflicts); the two normalize passes move carries
//   by shuffles; the fold is one 35-term dot product per output limb;
// - FOLD is copied into shared memory per block: lanes read different
//   entries of it at once, which the constant cache would serialize.
// The critical path of one addition is then about two products deep
// instead of twelve. padd381_kernel stages up to 8 neighbouring lanes'
// operands per block (one 32-byte sector per row) and adds them in turn.
// horner381_kernel runs the whole Horner chain (64 windows x 4 doublings +
// 1 addition) in one launch with the 64 window sums in shared memory, then
// field381.canonical of X, Y and Z (one thread per coordinate), and writes
// both the raw accumulator and its canonical limbs. This does the earlier
// design's later work: shared-memory staging, and one launch for the chain.

#include <cuda_runtime.h>

#define NL 33
#define LIMB_BITS 12
#define LIMB_MASK 0xFFF
#define WARPS 6
#define THREADS (WARPS * 32)
#define FULL_MASK 0xFFFFFFFFu
#define PT 36       // ints per staged coordinate: 33 limbs, padded to 16 bytes
#define CHUNK_MAX 8  // lanes one padd381_kernel block stages at once
#define WINDOWS 64

// FOLD[j] = the 32 strict limbs of 2^(12 (j + 32)) mod p (ops/field381.py;
// tests/test_torch_bls.py checks this table against it). Row 1 (2^396 mod
// p) is also the top-limb fold of the parallel carry step.
__device__ const int kFold[35][32] = {
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
// field381._BIG_P (p * 2^15 as 32 strict limbs and a wide top limb) and k p
// for k = 8, 4, 2, 1 in strict limbs: the constants of field381.canonical
// (tests/test_torch_kernels3.py checks them against it).
__constant__ int kBigP[NL] = {
    0, 1368, 4053, 4095, 4095, 4087, 4060, 4095, 2217, 4085, 1535, 245, 2834, 1415, 123, 1685,
    920, 1531, 649, 1948, 1474, 954, 2994, 3430, 421, 3506, 3539, 600, 845, 3071, 1308, 2191,
    3328};
__constant__ int kKP[4][NL] = {
    {1368, 4053, 4095, 4095, 4087, 4060, 4095, 2217, 4085, 1535, 245, 2834, 1415, 123, 1685, 920,
     1531, 649, 1948, 1474, 954, 2994, 3430, 421, 3506, 3539, 600, 845, 3071, 1308, 2191, 3328, 0},
    {2732, 4074, 4095, 4095, 2043, 4078, 4095, 3156, 4090, 2815, 122, 3465, 2755, 2109, 842, 2508,
     2813, 324, 974, 737, 477, 1497, 3763, 210, 3801, 1769, 2348, 2470, 1535, 2702, 1095, 1664, 0},
    {1366, 4085, 4095, 4095, 1021, 4087, 2047, 1578, 4093, 1407, 2109, 3780, 3425, 1054, 421, 3302,
     1406, 162, 2535, 2416, 2286, 2796, 1881, 2153, 3948, 884, 1174, 3283, 767, 3399, 547, 832, 0},
    {2731, 4090, 4095, 4095, 2558, 4091, 1023, 2837, 4094, 2751, 1054, 3938, 1712, 2575, 210, 1651,
     703, 2129, 1267, 1208, 1143, 3446, 2988, 1076, 1974, 442, 2635, 3689, 2431, 3747, 273, 416, 0},
};

// Shared memory of one block: FOLD, the two product stages' results, and
// each warp's product scratch.
struct Coop {
  int fold[35][32];
  __align__(16) int t[WARPS][PT];   // t0 t1 t2 t3 t4 x3
  __align__(16) int u[WARPS][PT];   // the six products of X3, Y3, Z3
  __align__(16) int a[WARPS][32];   // multiplier limbs 0..31 (broadcast reads)
  __align__(16) int bb[WARPS][64];  // multiplicand limbs 0..31, twice
  __align__(16) int ch[WARPS][32];  // product columns 32..63 (broadcast reads)
};

__device__ __forceinline__ void load_fold(Coop& s) {
  for (int i = threadIdx.x; i < 35 * 32; i += blockDim.x) (&s.fold[0][0])[i] = (&kFold[0][0])[i];
}

// ---------------------------------------------------------------------------
// A field element across a warp: lane l holds limb l (l < 32), every lane
// holds limb 32. All 32 lanes of the warp call these functions together.
// ---------------------------------------------------------------------------

struct wfe {
  int lo;   // limb (lane)
  int top;  // limb 32
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ wfe wload(const int* s) { return {s[lane_id()], s[NL - 1]}; }

__device__ __forceinline__ void wstore(int* s, wfe x) {
  s[lane_id()] = x.lo;
  if (lane_id() == 0) s[NL - 1] = x.top;
}

// field381.carry: parallel carry steps; the carry out of limb 32 (weight
// 2^396) folds back through FOLD row 1 (f1 = this lane's entry of it).
template <int STEPS>
__device__ __forceinline__ wfe wcarry(wfe x, int f1) {
  const int lane = lane_id();
#pragma unroll
  for (int s = 0; s < STEPS; s++) {
    const int c = x.lo >> LIMB_BITS, c32 = x.top >> LIMB_BITS;
    const int up = __shfl_up_sync(FULL_MASK, c, 1);
    const int c31 = __shfl_sync(FULL_MASK, c, 31);
    x.lo = (x.lo & LIMB_MASK) + (lane == 0 ? 0 : up) + c32 * f1;
    x.top = (x.top & LIMB_MASK) + c31;
  }
  return x;
}

__device__ __forceinline__ wfe wadd(wfe a, wfe b, int f1) {
  return wcarry<2>({a.lo + b.lo, a.top + b.top}, f1);
}

__device__ __forceinline__ wfe wsub(wfe a, wfe b, int f1) {
  return wcarry<2>({a.lo - b.lo, a.top - b.top}, f1);
}

__device__ __forceinline__ wfe wmul_small(wfe a, int k, int f1) {
  return wcarry<3>({a.lo * k, a.top * k}, f1);
}

// field381.mul: a * b with the warp's scratch (sa, sbb, sch) in shared
// memory. Column k of the schoolbook product is sum_{i+j=k} a_i b_j over
// k = 0..64 (columns 65, 66 start at 0); lane l sums columns l and l + 32
// and every lane column 64; then two normalize passes, the fold and three
// carry steps, all as in field381.mul.
__device__ __forceinline__ wfe wmul(wfe a, wfe b, int* sa, int* sbb, int* sch,
                                    const int (*fold)[32], int f1) {
  const int lane = lane_id();
  __syncwarp();  // the warp's previous product has finished reading the scratch
  sa[lane] = a.lo;
  sbb[lane] = b.lo;
  sbb[lane + 32] = b.lo;
  __syncwarp();
  int lo = 0;                               // column l
  int hi = a.lo * b.top + a.top * b.lo;     // column l + 32: (i, j) = (l, 32), (32, l)
  const int4* a4 = reinterpret_cast<const int4*>(sa);
#pragma unroll
  for (int g = 0; g < 8; g++) {
    const int4 v = a4[g];
    const int av[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int i = 4 * g + k;
      // b_((l - i) mod 32): b_(l - i) for column l when i <= l, else
      // b_(l + 32 - i) for column l + 32
      const int p = av[k] * sbb[lane - i + 32];
      if (i <= lane) lo += p; else hi += p;
    }
  }
  int c64 = a.top * b.top, c65 = 0, c66 = 0;
#pragma unroll
  for (int s = 0; s < 2; s++) {  // c = (c & MASK) + shift_up(c >> 12)
    const int rl = lo >> LIMB_BITS, rh = hi >> LIMB_BITS;
    const int r64 = c64 >> LIMB_BITS, r65 = c65 >> LIMB_BITS;
    const int upl = __shfl_up_sync(FULL_MASK, rl, 1);
    const int uph = __shfl_up_sync(FULL_MASK, rh, 1);
    const int rl31 = __shfl_sync(FULL_MASK, rl, 31);
    const int rh31 = __shfl_sync(FULL_MASK, rh, 31);
    lo = (lo & LIMB_MASK) + (lane == 0 ? 0 : upl);
    hi = (hi & LIMB_MASK) + (lane == 0 ? rl31 : uph);
    c66 = (c66 & LIMB_MASK) + r65;
    c65 = (c65 & LIMB_MASK) + r64;
    c64 = (c64 & LIMB_MASK) + rh31;
  }
  // fold: limb l = column l + sum_j column (32 + j) * FOLD[j][l]; limb 32 = 0
  sch[lane] = hi;
  __syncwarp();
  int acc = lo + c64 * fold[32][lane] + c65 * fold[33][lane] + c66 * fold[34][lane];
  const int4* h4 = reinterpret_cast<const int4*>(sch);
#pragma unroll
  for (int g = 0; g < 8; g++) {
    const int4 h = h4[g];
    acc += h.x * fold[4 * g][lane] + h.y * fold[4 * g + 1][lane] +
           h.z * fold[4 * g + 2][lane] + h.w * fold[4 * g + 3][lane];
  }
  return wcarry<3>({acc, 0}, f1);
}

// ---------------------------------------------------------------------------
// Complete addition, RCB15 Algorithm 7 (a = 0, b3 = 12): cuda_group381.padd
// step for step, by the block's six warps. p, q, r are points staged in
// shared memory as [3][PT] (X, Y, Z); r may alias p or q. All THREADS
// threads call it; it ends with the block synchronized.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void coop_padd(const int* p, const int* q, int* r, Coop& s) {
  const int w = threadIdx.x >> 5, lane = lane_id();
  const int f1 = s.fold[1][lane];
  int* sa = s.a[w];
  int* sbb = s.bb[w];
  int* sch = s.ch[w];
  {
    // stage 1, warp w: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
    // t3 = (X1 + Y1)(X2 + Y2), t4 = (Y1 + Z1)(Y2 + Z2), x3 = (X1 + Z1)(X2 + Z2)
    const int c0 = w < 3 ? w : (w == 4 ? 1 : 0);
    const int c1 = w == 3 ? 1 : 2;
    wfe x = wload(p + PT * c0), y = wload(q + PT * c0);
    if (w >= 3) {
      x = wadd(x, wload(p + PT * c1), f1);
      y = wadd(y, wload(q + PT * c1), f1);
    }
    wstore(s.t[w], wmul(x, y, sa, sbb, sch, s.fold, f1));
  }
  __syncthreads();
  {
    // stage 2, warp w: u0 = t3' t1', u1 = t4' y3', u2 = y3' x3', u3 = t1' z3,
    // u4 = z3 t4', u5 = x3' t3' with t3' = t3 - (t0 + t1), t4' = t4 - (t1 + t2),
    // y3' = 12 (x3 - (t0 + t2)), x3' = 3 t0, z3 = t1 + 12 t2, t1' = t1 - 12 t2
    const wfe t0 = wload(s.t[0]), t1 = wload(s.t[1]), t2 = wload(s.t[2]);
    wfe x, y;
    if (w == 0 || w == 3 || w == 4) {
      const wfe b3t2 = wmul_small(t2, 12, f1);
      if (w == 0) {
        x = wsub(wload(s.t[3]), wadd(t0, t1, f1), f1);
        y = wsub(t1, b3t2, f1);
      } else if (w == 3) {
        x = wsub(t1, b3t2, f1);
        y = wadd(t1, b3t2, f1);
      } else {
        x = wadd(t1, b3t2, f1);
        y = wsub(wload(s.t[4]), wadd(t1, t2, f1), f1);
      }
    } else if (w == 5) {
      x = wadd(wadd(t0, t0, f1), t0, f1);
      y = wsub(wload(s.t[3]), wadd(t0, t1, f1), f1);
    } else {
      const wfe y3 = wmul_small(wsub(wload(s.t[5]), wadd(t0, t2, f1), f1), 12, f1);
      if (w == 1) {
        x = wsub(wload(s.t[4]), wadd(t1, t2, f1), f1);
        y = y3;
      } else {
        x = y3;
        y = wadd(wadd(t0, t0, f1), t0, f1);
      }
    }
    wstore(s.u[w], wmul(x, y, sa, sbb, sch, s.fold, f1));
  }
  __syncthreads();
  if (w < 3) {  // X3 = u0 - u1, Y3 = u2 + u3, Z3 = u4 + u5
    const wfe a = wload(s.u[2 * w]), b = wload(s.u[2 * w + 1]);
    wstore(r + PT * w, w == 0 ? wsub(a, b, f1) : wadd(a, b, f1));
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// field381.canonical, one thread per coordinate: the BIG_P offset, three
// sequential passes, four folds of the top limb, and the conditional
// subtractions of 8p, 4p, 2p and p.
// ---------------------------------------------------------------------------

// field381._seq_pass: exact sequential carry; the carry out of limb 32
// folds back through FOLD row 1 into limbs 0..31.
__device__ __forceinline__ void seq_pass(int (&x)[NL], const int* f1) {
  int carry = 0;
#pragma unroll
  for (int i = 0; i < NL; i++) {
    const int v = x[i] + carry;
    x[i] = v & LIMB_MASK;
    carry = v >> LIMB_BITS;
  }
#pragma unroll
  for (int i = 0; i < NL - 1; i++) x[i] += carry * f1[i];
}

__device__ __forceinline__ void canonical33(const int* in, int* out, const int (*fold)[32]) {
  int x[NL];
#pragma unroll
  for (int i = 0; i < NL; i++) x[i] = in[i] + kBigP[i];
#pragma unroll 1
  for (int s = 0; s < 3; s++) seq_pass(x, fold[1]);
#pragma unroll 1
  for (int s = 0; s < 4; s++) {
    const int top = x[NL - 1];
#pragma unroll
    for (int i = 0; i < NL - 1; i++) x[i] += top * fold[0][i];
    x[NL - 1] = 0;
    seq_pass(x, fold[1]);
  }
#pragma unroll
  for (int k = 0; k < 4; k++) {  // field381._cond_sub with 8p, 4p, 2p, p
    int d[NL];
    int carry = 0;
#pragma unroll
    for (int i = 0; i < NL; i++) {
      const int v = x[i] - kKP[k][i] + carry;
      d[i] = v & LIMB_MASK;
      carry = v >> LIMB_BITS;
    }
    if (carry >= 0) {
#pragma unroll
      for (int i = 0; i < NL; i++) x[i] = d[i];
    }
  }
#pragma unroll
  for (int i = 0; i < NL; i++) out[i] = x[i];
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// Replaces pallas_group381._padd381_kernel: p + q for packed XYZ [99, n]
// operands with row strides ldp, ldq; out [99, n] with row stride ldo. Block
// b adds lanes [b * chunk, b * chunk + chunk) one after another.
__global__ void __launch_bounds__(THREADS)
padd381_kernel(const int* __restrict__ p, long long ldp, const int* __restrict__ q,
               long long ldq, int* __restrict__ out, long long ldo, long long n, int chunk) {
  __shared__ Coop s;
  __shared__ __align__(16) int pts[2][CHUNK_MAX][3][PT];  // P and Q; the sum overwrites P
  const long long base = (long long)blockIdx.x * chunk;
  const int m = (int)(n - base < chunk ? n - base : chunk);
  load_fold(s);
  for (int i = threadIdx.x; i < 2 * 3 * NL * m; i += THREADS) {
    const int which = i / (3 * NL * m), row = i % (3 * NL * m) / m, k = i % m;
    const int* src = which ? q + row * ldq : p + row * ldp;
    pts[which][k][row / NL][row % NL] = src[base + k];
  }
  __syncthreads();
  for (int k = 0; k < m; k++) coop_padd(&pts[0][k][0][0], &pts[1][k][0][0], &pts[0][k][0][0], s);
  for (int i = threadIdx.x; i < 3 * NL * m; i += THREADS) {
    const int row = i / m, k = i % m;
    out[row * ldo + base + k] = pts[0][k][row / NL][row % NL];
  }
}

// The Horner combination of bls_msm.horner_combine and the canonical form
// of bls_msm.unpack_point: acc = identity; for i = 0..63: acc = 2^4 acc
// (four padd(acc, acc)), acc = acc + S_(63 - i); then canonical(X, Y, Z).
// w: window sums [99, 64] with row stride ldw; raw: [99] (the accumulator,
// limb-major); canon: [3, 33].
__global__ void __launch_bounds__(THREADS)
horner381_kernel(const int* __restrict__ w, long long ldw, int* __restrict__ raw,
                 int* __restrict__ canon) {
  __shared__ Coop s;
  __shared__ __align__(16) int win[WINDOWS][3][PT];
  __shared__ __align__(16) int acc[3][PT];
  load_fold(s);
  for (int i = threadIdx.x; i < 3 * NL * WINDOWS; i += THREADS) {
    const int row = i / WINDOWS, j = i % WINDOWS;
    win[j][row / NL][row % NL] = w[row * ldw + j];
  }
  for (int i = threadIdx.x; i < 3 * PT; i += THREADS) (&acc[0][0])[i] = (i == PT);  // (0 : 1 : 0)
  __syncthreads();
  int* a = &acc[0][0];
#pragma unroll 1
  for (int i = 0; i < WINDOWS; i++) {
#pragma unroll 1
    for (int d = 0; d < 4; d++) coop_padd(a, a, a, s);
    coop_padd(a, &win[WINDOWS - 1 - i][0][0], a, s);
  }
  for (int i = threadIdx.x; i < 3 * NL; i += THREADS) raw[i] = acc[i / NL][i % NL];
  if (threadIdx.x < 3) canonical33(acc[threadIdx.x], canon + NL * threadIdx.x, s.fold);
}

// ---------------------------------------------------------------------------
// C interface: launches on the given stream and returns cudaGetLastError()
// (0 on success). n == 0 launches nothing.
// ---------------------------------------------------------------------------

extern "C" int dr_padd381_xx(const int* p, long long ldp, const int* q, long long ldq,
                             int* out, long long ldo, long long n, void* stream) {
  if (n > 0) {
    // Lanes per block: 1 while the card has a block slot for every lane
    // (the MSM's table steps and deep tree levels), up to CHUNK_MAX once
    // the lanes outnumber ~4 resident blocks per SM many times over.
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    int chunk = 1;
    while (chunk < CHUNK_MAX && n >= 2LL * chunk * 4 * sms) chunk *= 2;
    const long long blocks = (n + chunk - 1) / chunk;
    padd381_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        p, ldp, q, ldq, out, ldo, n, chunk);
  }
  return (int)cudaGetLastError();
}

extern "C" int dr_horner381(const int* w, long long ldw, int* raw, int* canon, void* stream) {
  horner381_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(w, ldw, raw, canon);
  return (int)cudaGetLastError();
}
